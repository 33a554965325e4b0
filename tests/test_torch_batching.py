"""The port's host-side data path against the JAX package's: radius graphs,
pad buckets, collate, loaders, the in-memory data pipeline and the config
derivations. These are numpy on both sides, so every array must be equal,
not close.
"""

import copy

import numpy as np
import pytest
import torch

import torch_port_util as tpu
from conftest import random_molecule_samples
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.config.schema import ModelSpec as JaxModelSpec
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.graphs import batching as jb
from hydragnn_tpu.graphs.radius import radius_graph as jax_radius_graph
from hydragnn_tpu.preprocess.load_data import (
    dataset_loading_and_splitting as jax_loading,
)
from hydragnn_tpu_torch.config import update_config as port_update_config
from hydragnn_tpu_torch.config.schema import ModelSpec as PortModelSpec
from hydragnn_tpu_torch.graphs import batching as pb
from hydragnn_tpu_torch.graphs.graph import FIELDS
from hydragnn_tpu_torch.graphs.radius import radius_graph as port_radius_graph
from hydragnn_tpu_torch.preprocess.load_data import (
    dataset_loading_and_splitting as port_loading,
)
from test_config import CI_CONFIG


def _datasets():
    return {
        "bcc": deterministic_graph_data(number_configurations=24, seed=7),
        "molecules": random_molecule_samples(24, seed=7),
    }


@pytest.fixture(scope="module", params=["bcc", "molecules"])
def dataset(request):
    return _datasets()[request.param]


def _assert_batches_equal(jax_batch, port_batch):
    for f in FIELDS:
        a = np.asarray(getattr(jax_batch, f))
        b = getattr(port_batch, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f"field {f} differs"


def test_collate_bit_equal_and_certified(dataset):
    pad_j = jb.compute_pad_spec(dataset, 8)
    pad_p = pb.compute_pad_spec(tpu.port_samples(dataset), 8)
    assert pad_j.as_tuple() == pad_p.as_tuple() and pad_j.node_cap == pad_p.node_cap
    for start in (0, 8, 16):
        chunk = dataset[start : start + 8]
        bj = jb.collate(chunk, pad_j)
        bp = pb.collate(tpu.port_samples(chunk), pad_p)
        _assert_batches_equal(bj, bp)
        # the sortedness certificates that let the CSR kernels skip a sort
        assert bp.meta.recv_sorted and bp.meta.batch_sorted
        assert bp.meta.send_sorted == bool(np.all(np.diff(bj.senders) >= 0))
        assert bp.meta.max_n_node == bj.meta.max_n_node


def test_unsorted_sample_is_not_certified():
    s = tpu.port_samples(random_molecule_samples(2, seed=1))
    p = np.random.default_rng(0).permutation(s[0].num_edges)
    s[0].senders, s[0].receivers = s[0].senders[p], s[0].receivers[p]
    b = pb.collate(s, pb.compute_pad_spec(s, 2))
    assert b.meta.recv_sorted is False and b.meta.batch_sorted is True
    # the kernels then follow the stable sort permutation
    idx = b.csr("receivers")
    assert idx.perm is not None
    assert b.csr("receivers") is idx, "the CSR view is built once per batch"


def test_pad_buckets_and_pick_bucket_match(dataset):
    bj = jb.compute_pad_buckets(dataset, 8, max_buckets=4)
    bp = pb.compute_pad_buckets(tpu.port_samples(dataset), 8, max_buckets=4)
    assert [b.as_tuple() for b in bj] == [b.as_tuple() for b in bp]
    assert [b.node_cap for b in bj] == [b.node_cap for b in bp]
    rng = np.random.default_rng(3)
    top = bj[-1]
    for _ in range(50):
        n = int(rng.integers(1, top.n_node + 8))
        e = int(rng.integers(0, top.n_edge + 64))
        g = int(rng.integers(0, top.n_graph + 1))
        pj = jb.pick_bucket(bj, n, e, 0, g)
        pp = pb.pick_bucket(bp, n, e, 0, g)
        assert (pj is None) == (pp is None)
        if pj is not None:
            assert pj.as_tuple() == pp.as_tuple()


def test_qm9_sized_buckets_at_batch_64():
    """The serving path's shapes: QM9-sized molecules at batch 64 give four
    buckets whose node slots leave room for the reserved pad node."""
    samples = random_molecule_samples(160, seed=11)
    bj = jb.compute_pad_buckets(samples, 64, max_buckets=4)
    bp = pb.compute_pad_buckets(tpu.port_samples(samples), 64, max_buckets=4)
    assert [b.as_tuple() for b in bj] == [b.as_tuple() for b in bp]
    assert len(bp) == 4 and all(b.n_graph == 65 for b in bp)


def test_graph_loader_plan_and_batches_match(dataset):
    lj = jb.GraphLoader(dataset, 6, shuffle=True, seed=2, buckets=3, drop_last=False)
    lp = pb.GraphLoader(tpu.port_samples(dataset), 6, shuffle=True, seed=2, buckets=3,
                        drop_last=False)
    for epoch in (0, 1):
        lj.set_epoch(epoch)
        lp.set_epoch(epoch)
        plan_j, plan_p = lj.batch_plan(), lp.batch_plan()
        assert len(plan_j) == len(plan_p) == len(lp)
        for (cj, pj), (cp, pp) in zip(plan_j, plan_p):
            assert np.array_equal(cj, cp) and pj.as_tuple() == pp.as_tuple()
        for bj, bp in zip(lj, lp):
            _assert_batches_equal(bj, bp)


@pytest.mark.parametrize("case", ["open", "pbc", "pruned", "large"])
def test_radius_graph_matches(case):
    rng = np.random.default_rng(["open", "pbc", "pruned", "large"].index(case))
    kw = {}
    if case == "pbc":
        pos = rng.uniform(0, 4.0, size=(12, 3))
        kw = dict(cell=np.eye(3) * 4.0, pbc=np.array([True, True, False]))
    elif case == "large":  # above the brute-force limit: the binned search
        pos = rng.uniform(0, 20.0, size=(600, 3))
    else:
        pos = rng.uniform(0, 6.0, size=(25, 3))
    if case == "pruned":
        kw["max_neighbours"] = 4
    sj, rj, shj = jax_radius_graph(pos, 3.0, **kw)
    sp, rp, shp = port_radius_graph(pos, 3.0, **kw)
    assert np.array_equal(sj, sp) and np.array_equal(rj, rp) and np.array_equal(shj, shp)
    assert np.all(np.diff(rp) >= 0), "edges come receiver-sorted"


def test_build_radius_graph_ensure_connected_matches():
    from hydragnn_tpu.graphs.graph import GraphSample
    from hydragnn_tpu.graphs.radius import build_radius_graph as jbuild
    from hydragnn_tpu_torch.graphs.radius import build_radius_graph as pbuild

    pos = np.array([[0.0, 0, 0], [1.0, 0, 0], [9.0, 0, 0]])  # atom 2 is isolated
    js = GraphSample(x=np.ones((3, 1), np.float32), pos=pos)
    ps = tpu.port_samples([js])[0]
    jbuild(js, 2.0)
    pbuild(ps, 2.0)
    assert np.array_equal(js.senders, ps.senders) and np.array_equal(js.receivers, ps.receivers)
    np.testing.assert_array_equal(js.edge_shifts, ps.edge_shifts)
    assert 2 in ps.receivers


def _voi_config(multihead: bool):
    cfg = copy.deepcopy(CI_CONFIG)
    if multihead:
        cfg["NeuralNetwork"]["Variables_of_interest"].update(
            output_names=["sum", "x", "x2"], output_index=[0, 1, 2],
            type=["graph", "node", "node"])
        cfg["NeuralNetwork"]["Architecture"]["task_weights"] = [2.0, 1.0, 1.0]
        cfg["NeuralNetwork"]["Architecture"]["output_heads"]["node"] = {
            "num_headlayers": 2, "dim_headlayers": [8, 8], "type": "mlp"}
    cfg["NeuralNetwork"]["Training"]["pad_buckets"] = 3
    return cfg


@pytest.mark.parametrize("multihead", [False, True])
def test_data_pipeline_and_config_match(multihead):
    """``dataset_loading_and_splitting(samples=...)`` then ``update_config``:
    the same splits, normalised arrays, min-max tables, buckets and derived
    architecture fields."""
    cfg = _voi_config(multihead)
    samples = deterministic_graph_data(number_configurations=40, seed=5)
    cj, cp = copy.deepcopy(cfg), copy.deepcopy(cfg)
    loaders_j = jax_loading(cj, samples=tpu.jax_samples_copy(samples))
    loaders_p = port_loading(cp, samples=tpu.port_samples(samples))
    voi_j = cj["NeuralNetwork"]["Variables_of_interest"]
    voi_p = cp["NeuralNetwork"]["Variables_of_interest"]
    for key in ("minmax_node_feature", "minmax_graph_feature"):
        np.testing.assert_array_equal(np.asarray(voi_j[key]), np.asarray(voi_p[key]))
    for lj, lp in zip(loaders_j, loaders_p):
        assert len(lj.samples) == len(lp.samples)
        assert [b.as_tuple() for b in lj.buckets] == [b.as_tuple() for b in lp.buckets]
        for bj, bp in zip(lj, lp):
            _assert_batches_equal(bj, bp)

    aug_j = jax_update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders_j))
    aug_p = port_update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders_p))
    arch_j = aug_j["NeuralNetwork"]["Architecture"]
    arch_p = aug_p["NeuralNetwork"]["Architecture"]
    for key in ("output_dim", "output_type", "input_dim", "output_heads"):
        assert arch_j[key] == arch_p[key], key
    spec_j = JaxModelSpec.from_config(aug_j)
    spec_p = PortModelSpec.from_config(aug_p)
    for f in ("mpnn_type", "input_dim", "hidden_dim", "num_conv_layers", "output_dim",
              "output_type", "task_weights", "activation", "graph_pooling"):
        assert getattr(spec_j, f) == getattr(spec_p, f), f
    assert [dataclass_fields(b) for b in spec_j.graph_heads] == \
        [dataclass_fields(b) for b in spec_p.graph_heads]
    assert [dataclass_fields(b) for b in spec_j.node_heads] == \
        [dataclass_fields(b) for b in spec_p.node_heads]


def dataclass_fields(obj):
    import dataclasses

    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_update_config_rejects_bad_serving_and_precision():
    samples = tpu.port_samples(deterministic_graph_data(number_configurations=4, seed=0))
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["Serving"] = {"queue_depth": 0}
    with pytest.raises(ValueError, match="queue_depth"):
        port_update_config(cfg, samples)
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["Serving"] = {"queue_depth": 8, "typo_key": 1}
    with pytest.raises(ValueError, match="Unknown Serving key"):
        port_update_config(cfg, samples)
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Training"]["precision"] = "int4"
    with pytest.raises(ValueError, match="precision"):
        port_update_config(cfg, samples)


def test_serving_block_of_the_jax_package_is_accepted_until_it_asks_for_more():
    """A config augmented by the JAX package carries its Serving keys: the
    port reads the quantized-serving ones (``quantize``, ``quant_tol``,
    ``quant_calib_batches``) with the JAX package's defaults and validation,
    and accepts ``fleet``, which the in-process server does not read."""
    samples = deterministic_graph_data(number_configurations=4, seed=0)
    jaug = jax_update_config(copy.deepcopy(CI_CONFIG), samples)
    assert "quantize" in jaug["Serving"] and "fleet" in jaug["Serving"]
    aug = port_update_config(jaug, tpu.port_samples(samples))
    assert aug["Serving"]["queue_depth"] == jaug["Serving"]["queue_depth"]
    for key in ("quantize", "quant_tol", "quant_calib_batches"):
        assert aug["Serving"][key] == jaug["Serving"][key]
    jaug["Serving"].update(quantize=True, quant_tol=0.5)
    aug = port_update_config(jaug, tpu.port_samples(samples))
    assert aug["Serving"]["quantize"] is True and aug["Serving"]["quant_tol"] == 0.5
    for bad, match in (({"quantize": True, "warmup": False}, "quantize requires"),
                       ({"quant_tol": 0.0}, "quant_tol"),
                       ({"quant_calib_batches": 0}, "quant_calib_batches")):
        cfg = copy.deepcopy(jaug)
        cfg["Serving"].update(bad)
        with pytest.raises(ValueError, match=match):
            port_update_config(cfg, tpu.port_samples(samples))


def test_batch_to_and_float_cast_share_ids():
    s = tpu.port_samples(random_molecule_samples(3, seed=2))
    b = pb.collate(s, pb.compute_pad_spec(s, 3))
    idx = b.csr("batch")
    half = b.map_floats(lambda t: t.to(torch.bfloat16))
    assert half.x.dtype == torch.bfloat16 and half.senders.dtype == torch.int32
    assert half.csr("batch") is idx, "a cast batch keeps the CSR cache of its ids"
    moved = b.to("cpu")
    assert moved.meta == b.meta and torch.equal(moved.receivers, b.receivers)
