"""The port's multibranch loaders (``train/multibranch.py``) against the
JAX package's (``hydragnn_tpu/train/multibranch.py``) on the same samples:
``concat_multidataset``'s tags, ``OversamplingLoader``'s epoch indices and
batch plans for three epochs and two seeds, ``make_branch_loaders``' pad
spec and per-branch sizes, and ``interleave_branch_batches``' order; all
exact (numpy draws and integer bookkeeping).
"""

import numpy as np
import pytest

import torch_port_util as tpu
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.train import multibranch as jmb
from hydragnn_tpu_torch.train import multibranch as mb


def datasets():
    return [deterministic_graph_data(number_configurations=n, seed=100 + b)
            for b, n in enumerate((20, 9, 13))]


def both():
    """The same three datasets as the JAX package's and the port's
    samples."""
    sets = datasets()
    return ([tpu.jax_samples_copy(s) for s in sets], [tpu.port_samples(s) for s in sets])


def test_concat_multidataset_tags_like_jax():
    jsets, psets = both()
    jall = jmb.concat_multidataset({f"d{i}": s for i, s in enumerate(jsets)})
    pall = mb.concat_multidataset({f"d{i}": s for i, s in enumerate(psets)})
    assert [s.dataset_id for s in pall] == [s.dataset_id for s in jall]
    assert [s.dataset_id for s in pall] == [0] * 20 + [1] * 9 + [2] * 13
    assert [s.num_nodes for s in pall] == [s.num_nodes for s in jall]


@pytest.mark.parametrize("seed", [0, 5])
def test_oversampling_indices_equal_jax(seed):
    from hydragnn_tpu.graphs.batching import compute_pad_spec as jax_pad_spec
    from hydragnn_tpu_torch.graphs.batching import compute_pad_spec

    jsets, psets = both()
    jl = jmb.OversamplingLoader(jsets[1], 4, num_samples=20, seed=seed,
                                pad=jax_pad_spec(jsets[1], 4))
    pl = mb.OversamplingLoader(psets[1], 4, num_samples=20, seed=seed,
                               pad=compute_pad_spec(psets[1], 4))
    for epoch in range(3):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        want = jl._epoch_indices()
        got = pl._epoch_indices()
        np.testing.assert_array_equal(got, want)
        assert len(got) == 20 and got.max() < 9
        assert len(pl) == len(jl) == 5
        for (jc, jp), (pc, pp) in zip(jl.batch_plan(), pl.batch_plan(), strict=True):
            np.testing.assert_array_equal(pc, jc)
            assert pp.as_tuple() == jp.as_tuple()


def test_make_branch_loaders_like_jax():
    jsets, psets = both()
    jloaders, jpad = jmb.make_branch_loaders(jsets, batch_size=4, seed=3, min_samples=24)
    ploaders, ppad = mb.make_branch_loaders(psets, batch_size=4, seed=3, min_samples=24)
    assert ppad.as_tuple() == jpad.as_tuple()
    assert [ld.num_samples for ld in ploaders] == [ld.num_samples for ld in jloaders] == [24] * 3
    assert [ld.seed for ld in ploaders] == [3, 34, 65]
    for jl, pl in zip(jloaders, ploaders):
        assert pl.pad.as_tuple() == jl.pad.as_tuple()
    # without a floor, every branch is sized to the largest
    loaders, _ = mb.make_branch_loaders(psets, batch_size=4)
    assert [ld.num_samples for ld in loaders] == [20] * 3


def test_interleave_branch_batches_like_jax():
    jsets, psets = both()
    jloaders, _ = jmb.make_branch_loaders(jsets, batch_size=4, seed=1)
    ploaders, _ = mb.make_branch_loaders(psets, batch_size=4, seed=1)
    for epoch in (0, 2):
        jsteps = list(jmb.interleave_branch_batches(jloaders, epoch))
        psteps = list(mb.interleave_branch_batches(ploaders, epoch))
        assert len(psteps) == len(jsteps) == 5
        for js, ps in zip(jsteps, psteps):
            assert len(ps) == 3
            for branch, (jb, pb) in enumerate(zip(js, ps)):
                ids = pb.dataset_id.numpy()[pb.graph_mask.numpy() > 0]
                assert (ids == branch).all()
                np.testing.assert_array_equal(pb.x.numpy(), np.asarray(jb.x))
                np.testing.assert_array_equal(pb.senders.numpy(), np.asarray(jb.senders))
