"""The port's edge-sharded route (``hydragnn_tpu_torch/parallel/
large_graph.py`` over ``models/common.py``'s edge-space helpers) for the
invariant stacks SAGE, MFC, CGCNN, PNA and PNAPlus on two ``gloo`` ranks,
against the JAX package's edge-sharded steps on a 2-device mesh and the
port's one-device steps (``torch_edge_sharded_util.py``: hidden 8, 2 conv
layers, four 400-atom graphs; outputs, eval metrics, one SGD step at lr
0.1, every gradient; the ranks' parameters bit-equal after the step).

Tolerance: rtol 1e-5 / atol 1e-6, as ``test_torch_large_graph.py``: each
node's sums, counts and means add two ranks' partial sums where one
device adds one run.

PNA's min and max: each rank's extreme keeps the reduction's identity, the
ranks' extremes are reduced, and only then do non-finite results become 0;
a cross-rank tie splits the gradient as one device splits it among tied
entries (``parallel/comm.py::all_reduce_extreme``).
"""

import numpy as np
import pytest
import torch

import torch_edge_sharded_util as esu
from torch_parallel_pool import WorkerPool


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = WorkerPool(tmp_path_factory.mktemp("edge_invariant"))
    yield p
    p.close()


@pytest.mark.parametrize("stack", ["SAGE", "MFC", "CGCNN", "PNA", "PNAPlus"])
def test_invariant_stack_edge_sharded_matches_jax_and_one_device(pool, stack):
    esu.check_stack(pool, stack)


def test_pna_extremes_with_ties_across_ranks_match_one_device(pool):
    """PNA's extremes over two ranks' halves of the rows, with segments
    whose extreme is tied within a rank and across the ranks, segments
    empty on one rank (its identity must not enter the reduction) and
    segments empty on both (0): the values and the rows' gradients against
    one device's ``segment_max`` / ``segment_min``."""
    from hydragnn_tpu_torch.graphs import segment

    rng = np.random.default_rng(5)
    e, n, f = 40, 9, 3
    data = rng.integers(-2, 3, size=(e, f)).astype(np.float32)  # many ties
    ids = np.concatenate([rng.integers(0, 4, e // 2),  # segments 0-3 on rank 0 ...
                          rng.integers(2, 7, e // 2)]).astype(np.int64)  # ... 2-6 on rank 1
    data[ids == 5] = -3.0  # a segment whose every entry ties, on rank 1 alone
    g = rng.normal(size=(n, f)).astype(np.float32)
    outs = pool.run("edge_extremes", {"data": data, "ids": ids, "n": n, "g": g})
    for kind, fn in (("max", segment.segment_max), ("min", segment.segment_min)):
        x = torch.tensor(data, requires_grad=True)
        want = fn(x, torch.tensor(ids), n)
        (want * torch.tensor(g)).sum().backward()
        # segments 2 and 3 hold entries on both ranks; 7 and 8 on none
        both = np.isin(np.arange(n), ids[: e // 2]) & np.isin(np.arange(n), ids[e // 2:])
        assert both[2] and both[3] and not want[7:].any()
        for out in outs:
            np.testing.assert_array_equal(out[kind], want.detach().numpy(), err_msg=kind)
        got = np.concatenate([out[f"d{kind}"] for out in outs])
        np.testing.assert_allclose(got, x.grad.numpy(), rtol=1e-6, atol=1e-7, err_msg=kind)
    # a tie across the ranks exists and its gradient is split over both
    hit = (data[: e // 2] == 2.0) & (ids[: e // 2, None] == 2)
    assert hit.any() or ((data[e // 2:] == 2.0) & (ids[e // 2:, None] == 2)).any()


def _nodes_at_half_the_edges(spec):
    """A pad spec whose node count is half its edge count: two ranks' edge
    blocks of ``E / 2`` rows would be as many rows as the nodes."""
    return type(spec)(n_node=spec.n_edge // 2, n_edge=spec.n_edge, n_graph=spec.n_graph,
                      n_triplet=spec.n_triplet, node_cap=spec.node_cap,
                      attn_cap=spec.attn_cap)


def test_edge_share_keeps_edge_rows_apart_from_node_rows(pool):
    """Where a rank's edge block would have as many rows as the batch has
    nodes (here ``N = E / 2`` at two ranks), ``edge_share`` pads the edges
    by one more row a rank, so the layers applied to node rows (PNA's
    ``post_nn`` and ``lin``) keep their parameters out of the edge space
    while those applied to edge rows (its ``pre_nn``) enter it: the step
    matches the one-device step and the ranks' parameters agree. A share
    cut by hand with edge rows as many as its nodes is refused."""
    from hydragnn_tpu_torch.convert import batch_from_numpy
    from hydragnn_tpu_torch.models.common import edge_sharded
    from hydragnn_tpu_torch.parallel.large_graph import edge_share

    esu.check_stack(pool, "PNA", jax=False, pad=_nodes_at_half_the_edges)
    _, jbatch, _, _ = esu.case("PNA", pad=_nodes_at_half_the_edges)
    batch = batch_from_numpy(jbatch)
    assert batch.num_nodes * 2 == batch.num_edges
    for rank in range(2):
        assert edge_share(batch, 2, rank).num_edges == batch.num_nodes + 1
    half = edge_share(batch, 2, 0)
    half.senders, half.receivers = half.senders[:-1], half.receivers[:-1]
    with pytest.raises(ValueError, match="node or graph count"):
        with edge_sharded(None, half):
            pass
