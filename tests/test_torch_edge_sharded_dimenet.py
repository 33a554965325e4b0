"""DimeNet on the port's edge-sharded route: ``edge_share`` gives each rank
the triplets whose ``idx_ji`` edge it holds, ``idx_ji`` renumbered into its
edge block and ``idx_kj`` left global; each interaction block all-gathers
the edge messages the triplets read (their gradient summed over the
ranks, then each rank's block), and the triplet sum into the ``ji`` edges
stays local on B1. On two ``gloo`` ranks against the JAX package's
edge-sharded steps on a 2-device mesh and the port's one-device steps
(``torch_edge_sharded_util.py``: hidden 8, 2 conv layers, four 400-atom
graphs with their triplets; outputs, eval metrics, one SGD step at lr 0.1,
every gradient; the ranks' parameters bit-equal after the step).

Tolerance, with its reason: DimeNet has no norm between its layers, and
this case's loss is ~1.1e4 with gradients of ~1e4, so one SGD step at lr
0.1 moves parameters by up to ~1.3e3 and a small entry of a tensor meets
the cancellation of sums of large terms. Each tensor is held at rtol 1e-5
and an atol of 1e-5 of its largest entry against the one-device step
(``test_torch_geometric_stacks.py`` holds DimeNet's forward to 1e-5 of the
head's largest output for the same reason), and 2e-5 of it against the
JAX package: the port's own one-device step lies 1.14e-5 of the largest
entry from the JAX package's step there (``graph_convs.0.out_lin_0``).
"""

import numpy as np
import pytest

import torch_edge_sharded_util as esu
from torch_parallel_pool import WorkerPool


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = WorkerPool(tmp_path_factory.mktemp("edge_dimenet"))
    yield p
    p.close()


def test_dimenet_edge_sharded_matches_jax_and_one_device(pool):
    esu.check_stack(pool, "DimeNet", scaled=1e-5, jax_scaled=2e-5)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_edge_share_renumbers_triplets_into_each_ranks_block(world):
    """Each rank keeps exactly the triplets whose ``idx_ji`` edge is in its
    block, in their order, ``idx_ji`` renumbered into the block (sorted,
    so certified), ``idx_kj`` global; every rank's count is padded to the
    largest with masked triplets; over the ranks the real triplets are the
    batch's; at two ranks and more, some triplet's ``kj`` edge lies on
    another rank."""
    from hydragnn_tpu_torch.convert import batch_from_numpy
    from hydragnn_tpu_torch.parallel.large_graph import edge_share

    _, jbatch, _, _ = esu.case("DimeNet", n_atoms=120, box=8.0)
    batch = batch_from_numpy(jbatch)
    kj, ji = batch.idx_kj.numpy(), batch.idx_ji.numpy()
    tm = batch.triplet_mask.numpy()
    per = -(-batch.num_edges // world)
    shares = [edge_share(batch, world, r) for r in range(world)]
    counts = {sh.idx_kj.shape[0] for sh in shares}
    assert len(counts) == 1, counts
    got, foreign = [], 0
    for r, sh in enumerate(shares):
        lji, lkj, ltm = sh.idx_ji.numpy(), sh.idx_kj.numpy(), sh.triplet_mask.numpy()
        assert ((lji >= 0) & (lji < per)).all() and (np.diff(lji) >= 0).all()
        assert sh.meta.ji_sorted
        mine = (ji // per) == r
        real = ltm > 0
        np.testing.assert_array_equal(lji[: mine.sum()], ji[mine] - r * per)
        np.testing.assert_array_equal(lkj[: mine.sum()], kj[mine])
        np.testing.assert_array_equal(ltm[: mine.sum()], tm[mine])
        assert not ltm[mine.sum():].any()
        got += [(int(a) + r * per, int(b)) for a, b in zip(lji[real], lkj[real])]
        foreign += int(((lkj[real] // per) != r).sum())
    assert got == [(int(a), int(b)) for a, b in zip(ji[tm > 0], kj[tm > 0])]
    assert (foreign > 0) == (world > 1)
