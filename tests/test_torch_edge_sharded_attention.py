"""GAT on the port's edge-sharded route, with its softmax through B3's
split form (each rank's per-row statistics, their combine over the ranks,
the normalisation), its self loops and alignment slots cut into one block
per rank, its attention dropout drawn over the whole layout, and its
``conv_checkpointing`` recompute in the first pass's edge group. On two
``gloo`` ranks against the JAX package's edge-sharded steps on a 2-device
mesh and the port's one-device steps (``torch_edge_sharded_util.py``:
hidden 8, 2 conv layers, four 400-atom graphs; outputs, eval metrics, one
SGD step at lr 0.1, every gradient; the ranks' parameters bit-equal after
the step). Then the split softmax alone: its plain versions against the
plain one-device softmax with the rows split so that some rank holds none
of a row's entries (bit-equal at one rank), and on two ranks with its
gradient.

Tolerance: rtol 1e-5 / atol 1e-6, as ``test_torch_large_graph.py``; the
attention dropout's masks are the port's generator's, so that case holds
the ranks against the port's one-device step alone (the JAX package's
masks are its own).
"""

import numpy as np
import pytest
import torch

import torch_edge_sharded_util as esu
from torch_parallel_pool import WorkerPool

TOL = esu.TOL


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = WorkerPool(tmp_path_factory.mktemp("edge_attention"))
    yield p
    p.close()


def test_gat_edge_sharded_matches_jax_and_one_device(pool):
    esu.check_stack(pool, "GAT")


def test_gat_conv_checkpointing_edge_sharded(pool):
    """GAT with ``conv_checkpointing`` on the edge-sharded route: against the
    JAX package and one device, and every gradient and parameter of the
    ranks bit-equal to the same step without checkpointing."""
    esu.check_stack(pool, "GAT", training={"conv_checkpointing": True})
    _, batch, aug, variables = esu.case("GAT", training={"conv_checkpointing": True})
    ckpt = esu.run_ranks(pool, aug, variables, batch)
    aug["NeuralNetwork"]["Training"]["conv_checkpointing"] = False
    plain = esu.run_ranks(pool, aug, variables, batch)
    for a, b in zip(ckpt, plain):
        for name in a["grads"]:
            np.testing.assert_array_equal(a["grads"][name], b["grads"][name], err_msg=name)
            np.testing.assert_array_equal(a["state"][name], b["state"][name], err_msg=name)


@pytest.mark.parametrize("ckpt", [False, True], ids=["plain", "checkpointed"])
def test_gat_attention_dropout_edge_sharded_matches_one_device(pool, ckpt):
    """GAT at dropout 0.25: every rank draws the mask over the whole layout
    from the shared generator and keeps its rows, so the ranks' step is the
    one-device step's with the same generator (the batch's edge count is
    even, so the two ranks' layout is the one device's); with
    ``conv_checkpointing`` the recompute replays the first pass's masks."""
    _, batch, aug, variables = esu.case("GAT", dropout=0.25,
                                        training={"conv_checkpointing": ckpt})
    assert np.asarray(batch.senders).shape[0] % 2 == 0
    outs = esu.run_ranks(pool, aug, variables, batch)
    m, grads = esu.port_single_seeded(aug, variables, batch)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["step"]["loss"], m["loss"], **TOL)
        for name, w in grads.items():
            np.testing.assert_allclose(out["grads"][name], w, **TOL,
                                       err_msg=f"rank {r} gradient {name}")
    for name in outs[0]["state"]:
        np.testing.assert_array_equal(outs[0]["state"][name], outs[1]["state"][name])


def _softmax_case(seed: int = 3):
    """Logits ``[E, 3]`` over 12 segments: segment 0 empty, segment 1 all
    -inf, segment 2 of one entry, the rest random (some -1e9 masked)."""
    rng = np.random.default_rng(seed)
    e, n = 160, 12
    ids = np.sort(rng.integers(3, n, e))
    ids[:3] = [1, 1, 2]
    x = (rng.normal(size=(e, 3)) * 3.0).astype(np.float32)
    x[ids == 1] = -np.inf
    x[rng.random(e) < 0.1] = -1e9
    return torch.tensor(x), torch.tensor(ids), n


def _blocks(e: int, world: int, rng) -> list:
    """``world`` row sets: a random permutation cut in ``world`` blocks, so
    that a rank may hold all, some or none of a segment's entries."""
    perm = rng.permutation(e)
    return [np.sort(b) for b in np.array_split(perm, world)]


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_split_softmax_plain_versions_match_the_one_device_softmax(world):
    """The split form's plain versions over ``world`` rank blocks, combined
    as the ranks combine them, against ``plain_segment_softmax`` of all the
    rows: bit-equal at one rank, within fp32 rounding at more; some rank
    holds none of some segment's entries."""
    from hydragnn_tpu_torch.ops import fused_softmax as fsm

    x, ids, n = _softmax_case()
    blocks = _blocks(x.shape[0], world, np.random.default_rng(world))
    stats = [fsm.plain_segment_softmax_stats(x[b], ids[b], n) for b in blocks]
    m_all = torch.stack([m for m, _ in stats]).amax(0)
    parts = [fsm.combine_softmax_stats(m, s, lambda t: m_all) for m, s in stats]
    shift, denom = parts[0][0], sum(p for _, p in parts)
    got = torch.empty_like(x)
    for b in blocks:
        got[b] = fsm.plain_segment_softmax_normalise(x[b], ids[b], shift, denom)
    want = fsm.plain_segment_softmax(x, ids, n)
    if world == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
        # segment 2's one entry (at least) is on one rank alone
        held = [set(ids[b].tolist()) for b in blocks]
        assert any(set(ids.tolist()) - h for h in held), "every rank holds every segment"
    assert not got[ids == 1].any()


def test_split_softmax_on_two_ranks_with_its_gradient(pool):
    """``edge_segment_softmax`` under ``edge_sharded`` on two ranks (each a
    random half of the rows), and its gradient against a cotangent, against
    one device's ``segment_softmax`` and autograd."""
    from hydragnn_tpu_torch.graphs import segment

    x, ids, n = _softmax_case(4)
    rng = np.random.default_rng(9)
    rows = _blocks(x.shape[0], 2, rng)
    g = rng.normal(size=x.shape).astype(np.float32)
    outs = pool.run("split_softmax", {"logits": x.numpy(), "ids": ids.numpy(), "n": n, "g": g,
                                      "rows": rows})
    xs = x.clone().requires_grad_()
    want = segment.segment_softmax(xs, ids, n)
    (want * torch.tensor(g)).sum().backward()
    for out, b in zip(outs, rows):
        np.testing.assert_allclose(out["out"], want.detach().numpy()[b], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["dx"], xs.grad.numpy()[b], rtol=1e-5, atol=1e-6)
