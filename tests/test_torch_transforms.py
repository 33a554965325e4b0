"""The port's geometric preprocessing (``hydragnn_tpu_torch/preprocess/
transforms.py``) against the JAX package's, on the CPU: every transform
bit-equal on the same samples, ``dataset_loading_and_splitting`` with
rotational invariance, edge lengths, both descriptors and subsampling
giving the same ``edge_attr`` and the same splits, and the global edge-length
normalisation's maximum taken over the processes of a ``torch.distributed``
group (two ``gloo`` processes here).
"""

import copy

import numpy as np
import pytest

import torch_port_util as tpu
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.preprocess import transforms as jax_tf
from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jax_loading
from hydragnn_tpu_torch.preprocess import transforms as tf
from test_config import CI_CONFIG
from test_transforms import make_sample

SAMPLE_FIELDS = ("pos", "forces_y", "edge_shifts", "edge_attr", "x", "senders", "receivers")


def _pair(seed: int, n: int = 4):
    """The same samples for both packages (JAX's, and the port's copies)."""
    jax_samples = [make_sample(seed=seed + i) for i in range(n)]
    for i, s in enumerate(jax_samples):
        rng = np.random.default_rng(100 + i)
        s.forces_y = rng.normal(size=s.forces_y.shape).astype(np.float32)
        s.edge_shifts = rng.normal(size=s.edge_shifts.shape).astype(np.float32)
        s.extras["normal"] = rng.normal(size=(s.num_nodes, 3))
    return jax_samples, tpu.port_samples(jax_samples)


def _assert_same(got, want):
    for f in SAMPLE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("name", ["normalize_rotation", "attach_edge_lengths",
                                  "spherical_features", "point_pair_features"])
def test_per_sample_transforms_bit_equal_jax(name):
    jax_samples, port = _pair(seed=1)
    for js, ps in zip(jax_samples, port):
        _assert_same(getattr(tf, name)(ps), getattr(jax_tf, name)(js))
    # chained on the same samples, as the pipeline chains them
    for js, ps in zip(jax_samples, port):
        _assert_same(getattr(tf, name)(ps), getattr(jax_tf, name)(js))


def test_spherical_features_without_normalisation_bit_equal_jax():
    jax_samples, port = _pair(seed=3)
    for js, ps in zip(jax_samples, port):
        _assert_same(tf.spherical_features(ps, norm=False),
                     jax_tf.spherical_features(js, norm=False))


def test_global_edge_length_normalisation_bit_equal_jax():
    jax_samples, port = _pair(seed=5)
    for js, ps in zip(jax_samples, port):
        jax_tf.attach_edge_lengths(js)
        tf.attach_edge_lengths(ps)
    assert tf.normalize_edge_lengths_global(port) == \
        jax_tf.normalize_edge_lengths_global(jax_samples)
    for js, ps in zip(jax_samples, port):
        _assert_same(ps, js)
    assert max(float(ps.edge_attr.max()) for ps in port) == 1.0
    # nothing to divide by: untouched, divisor 1
    empty = tpu.port_samples([make_sample(seed=9)])
    assert tf.normalize_edge_lengths_global(empty) == 1.0
    assert empty[0].edge_attr.shape[1] == 0


def test_composition_category_and_subsample_match_jax():
    samples = deterministic_graph_data(number_configurations=40, seed=7)
    port = tpu.port_samples(samples)
    assert [tf.composition_category(s) for s in port] == \
        [jax_tf.composition_category(s) for s in samples]
    for pct in (0.25, 0.5, 1.0):
        got = tf.stratified_subsample(port, pct, seed=3)
        want = jax_tf.stratified_subsample(samples, pct, seed=3)
        assert [port.index(s) for s in got] == [samples.index(s) for s in want]
    with pytest.raises(ValueError, match="subsample_percentage"):
        tf.stratified_subsample(port, 0.0)


def test_dataset_loading_with_every_option_matches_jax():
    """``Dataset.rotational_invariance``, ``compute_edge_lengths``, both
    ``Descriptors`` and ``subsample_percentage`` through
    ``dataset_loading_and_splitting``: 1 length + 3 spherical + 4
    point-pair columns, bit-equal to the JAX package's, and the same
    splits (``tests/test_transforms.py::test_pipeline_wiring_via_config``)."""
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = copy.deepcopy(CI_CONFIG)
    cfg["Dataset"]["rotational_invariance"] = True
    cfg["Dataset"]["compute_edge_lengths"] = True
    cfg["Dataset"]["Descriptors"] = {"spherical_coordinates": True, "point_pair_features": True}
    cfg["NeuralNetwork"]["Variables_of_interest"]["subsample_percentage"] = 0.75
    samples = [make_sample(seed=i, types=(1.0, 2.0, 3.0)) for i in range(40)]
    want = jax_loading(copy.deepcopy(cfg), samples=tpu.jax_samples_copy(samples))
    got = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=tpu.port_samples(samples))
    assert [len(ld.samples) for ld in got] == [len(ld.samples) for ld in want]
    assert sum(len(ld.samples) for ld in got) < 40
    for gl, wl in zip(got, want):
        for g, w in zip(gl.samples, wl.samples):
            assert g.edge_attr.shape[1] == 8
            for f in ("edge_attr", "pos", "x", "senders", "receivers", "graph_y"):
                assert np.array_equal(getattr(g, f), getattr(w, f)), f
    b = next(iter(got[0]))
    assert b.edge_attr.shape[1] == 8


def test_global_normalisation_takes_the_max_over_processes():
    """Under ``torch.distributed`` every process divides by the largest
    entry of any process (the reference's all-reduce MAX), not its own."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=tpu.gloo_normalise_worker, args=(r, 2, port, [2.0, 8.0], out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = sorted(out.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    assert got == [(0, 8.0, 0.25), (1, 8.0, 1.0)]
