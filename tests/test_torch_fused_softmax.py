"""The port's softmax ops (``hydragnn_tpu_torch.ops.fused_softmax``) against
the JAX package's on the same numpy inputs, on the CPU, where the port's
wrappers take their plain versions.

The JAX side runs as its own tests run it on the CPU: the segment softmax
through its Pallas path in interpret mode with the collate certificate
(``fused_segment_softmax(..., fits=True, interpret=True)``) and through
``reference_segment_softmax``; the masked softmax through
``fused_masked_softmax(..., interpret=True)`` and the plain
``softmax(where(mask, x, -1e9))``. The segment softmax runs on a collated
GAT-extended receiver layout (real edges, ``self_loop_pad`` slots on the
dummy node N-1, then ``arange(N)``) of 16 QM9-sized molecules in 472 node
slots: the Pallas route needs at least 256 segments, a multiple of 8.

Tolerances: fp32 at rtol 1e-5 / atol 1e-6, on real rows (entries whose
segment is not the dummy row N-1, where the Pallas kernel writes 0 for its
pad-exempt ids and the reference a finite value). The fp32 results differ
only in the order of the sums. bf16 outputs are fp32 results rounded once to
bf16 on both sides; they may land on neighbouring bf16 values (2^-8
relative), so bf16 compares at rtol 2^-7 / atol 1e-6. The JAX reference chain is
taken in fp32 for the bf16 cases: in bf16 it rounds every exp and partial
sum to bf16, which neither the Pallas kernel nor the port does (ROADMAP
queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from conftest import random_molecule_samples
from hydragnn_tpu.graphs.batching import collate, compute_pad_spec
from hydragnn_tpu.ops.fused_softmax import (
    fused_masked_softmax,
    fused_segment_softmax,
    reference_segment_softmax,
)
from hydragnn_tpu.ops.fused_softmax import self_loop_pad as jax_self_loop_pad
from hydragnn_tpu_torch.graphs import segment
from hydragnn_tpu_torch.ops import fused_scatter as fs
from hydragnn_tpu_torch.ops import fused_softmax as fsm

HEADS = 6
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def layout():
    """(extended receivers, extended mask, N) of a collated 16-molecule batch,
    built as the JAX GAT builds them."""
    samples = random_molecule_samples(16, seed=5)
    b = collate(samples, compute_pad_spec(samples, 16))
    n, e = b.x.shape[0], b.senders.shape[0]
    assert n >= 256 and n % 8 == 0 and b.meta.attn_fits
    pad = jax_self_loop_pad(e)
    recv = np.concatenate([b.receivers, np.full(pad, n - 1, np.int32),
                           np.arange(n, dtype=np.int32)])
    mask = np.concatenate([b.edge_mask, np.zeros(pad, np.float32), np.ones(n, np.float32)])
    return recv, mask, n


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _gat_logits(rng, mask):
    """Logits as GAT makes them: masked slots at -1e9."""
    x = rng.normal(scale=2.0, size=(mask.shape[0], HEADS)).astype(np.float32)
    return np.where(mask[:, None] > 0, x, np.float32(-1e9)).astype(np.float32)


def test_self_loop_pad_matches_jax():
    for e in (0, 1, 255, 256, 257, 17792):
        assert fsm.self_loop_pad(e) == jax_self_loop_pad(e)
        assert (e + fsm.self_loop_pad(e)) % 256 == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_segment_softmax_matches_jax(layout, dtype):
    recv, mask, n = layout
    x32 = _gat_logits(np.random.default_rng(0), mask)
    x_j = jnp.asarray(x32, JNP[dtype])
    pallas = fused_segment_softmax(x_j, jnp.asarray(recv), n, fits=True, interpret=True)
    reference = reference_segment_softmax(x_j.astype(jnp.float32), jnp.asarray(recv), n)
    before = dict(fs.LAUNCHES)
    got = fsm.segment_softmax(torch.from_numpy(x32).to(TORCH[dtype]), torch.from_numpy(recv), n)
    assert fs.LAUNCHES == before, "the CPU route must not count kernel launches"
    assert got.dtype == TORCH[dtype]
    real = recv != n - 1
    for want in (pallas, reference.astype(JNP[dtype])):
        np.testing.assert_allclose(_t32(got)[real], _f32(want)[real], **TOL[dtype])
    # every real row's weights sum to one; masked slots get exactly 0
    sums = np.zeros((n, HEADS))
    np.add.at(sums, recv[real], _t32(got)[real])
    np.testing.assert_allclose(sums[: n - 1][np.isin(np.arange(n - 1), recv[real])], 1.0,
                               rtol=1e-5 if dtype == "float32" else 3e-2)
    assert (_t32(got)[(mask == 0) & real] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_softmax_vjp_matches_jax(layout, dtype):
    """ds = s * (dy - segment_sum(s * dy)[ids]) against ``jax.vjp`` of the
    Pallas route (its custom VJP) and of the reference chain."""
    recv, mask, n = layout
    rng = np.random.default_rng(1)
    x32 = _gat_logits(rng, mask)
    dy32 = rng.normal(size=x32.shape).astype(np.float32)
    x_j, dy_j = jnp.asarray(x32, JNP[dtype]), jnp.asarray(dy32, JNP[dtype])
    ids = jnp.asarray(recv)

    def pallas(x):
        return fused_segment_softmax(x, ids, n, fits=True, interpret=True)

    def reference(x):
        return reference_segment_softmax(x.astype(jnp.float32), ids, n).astype(x.dtype)

    # in bf16 the reference's VJP differentiates through its fp32 chain, with
    # the weights unrounded, while the Pallas VJP (and the port) work from the
    # bf16 output; ds = s * (dy - t) cancels, so only the Pallas VJP is the
    # same function there
    fns = (pallas, reference) if dtype == "float32" else (pallas,)
    wants = [jax.vjp(f, x_j)[1](dy_j)[0] for f in fns]
    x_t = torch.from_numpy(x32).to(TORCH[dtype]).requires_grad_()
    fsm.segment_softmax(x_t, torch.from_numpy(recv), n).backward(
        torch.from_numpy(dy32).to(TORCH[dtype]))
    assert x_t.grad.dtype == TORCH[dtype]
    real = recv != n - 1
    for want in wants:
        np.testing.assert_allclose(_t32(x_t.grad)[real], _f32(want)[real],
                                   rtol=TOL[dtype]["rtol"], atol=1e-5)


def test_plain_segment_softmax_edge_cases():
    """Unsorted ids, an empty segment, a segment of -inf logits (its max is
    not finite: taken as 0, so its entries come out 0) and a segment of
    masked -1e9 logits (uniform), against an fp64 numpy chain."""
    rng = np.random.default_rng(2)
    ids = rng.permutation(np.repeat(np.arange(6), [5, 1, 7, 3, 4, 2]))
    ids = np.where(ids == 4, 7, ids).astype(np.int32)  # segment 4 empty, 7 used
    x = rng.normal(size=(ids.shape[0], 3)).astype(np.float32)
    x[ids == 3] = -np.inf
    x[ids == 5] = -1e9
    got = _t32(fsm.segment_softmax(torch.from_numpy(x), torch.from_numpy(ids), 8))
    want = np.zeros_like(x, dtype=np.float64)
    for s in range(8):
        sel = ids == s
        if not sel.any():
            continue
        mx = x[sel].astype(np.float64).max(axis=0)
        mx = np.where(np.isfinite(mx), mx, 0.0)
        ex = np.exp(x[sel] - mx)
        want[sel] = ex / np.maximum(ex.sum(axis=0), 1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[ids == 3] == 0).all()
    np.testing.assert_allclose(got[ids == 5], 0.5)


def test_segment_sum_of_messages_reaches_the_segment_sum_op(layout):
    """GAT's ``[E', heads, F]`` messages are summed as ``[E', heads * F]``
    by the segment-sum op (its kernel on the card), equal to ``index_add_``."""
    recv, _, n = layout
    msg = torch.randn(recv.shape[0], HEADS, 5, generator=torch.Generator().manual_seed(0))
    got = segment.segment_sum(msg, torch.from_numpy(recv), n)
    want = torch.zeros(n, HEADS, 5).index_add_(0, torch.from_numpy(recv).long(), msg)
    assert got.shape == (n, HEADS, 5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    flat = fs.plain_segment_sum(msg.reshape(recv.shape[0], -1), torch.from_numpy(recv), n)
    assert torch.equal(got.reshape(n, -1), flat)


# -- masked row softmax (GPS) ------------------------------------------------


def _dense_block(rng, g=9, heads=4, n_max=32, empty=(2, 8)):
    """Logits ``[G, H, n_max, n_max]`` and the per-graph validity ``[G,
    n_max]`` of graphs of random sizes; graphs ``empty`` have no nodes (all
    their rows fully masked, as the dummy graph's)."""
    n_node = rng.integers(5, n_max + 1, size=g)
    n_node[list(empty)] = 0
    valid = np.arange(n_max)[None, :] < n_node[:, None]
    x = rng.normal(scale=3.0, size=(g, heads, n_max, n_max)).astype(np.float32)
    return x, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_masked_softmax_matches_jax(dtype):
    x32, valid = _dense_block(np.random.default_rng(3))
    x_j = jnp.asarray(x32, JNP[dtype])
    mask_j = jnp.asarray(valid)[:, None, None, :]
    pallas = fused_masked_softmax(x_j, mask_j, interpret=True)
    reference = jax.nn.softmax(jnp.where(mask_j, x_j.astype(jnp.float32), -1e9), axis=-1)
    before = dict(fs.LAUNCHES)
    got = fsm.masked_softmax(torch.from_numpy(x32).to(TORCH[dtype]), torch.from_numpy(valid))
    assert fs.LAUNCHES == before, "the CPU route must not count kernel launches"
    assert got.dtype == TORCH[dtype]
    for want in (pallas, reference.astype(JNP[dtype])):
        np.testing.assert_allclose(_t32(got), _f32(want), **TOL[dtype])
    g = _t32(got)
    # fully masked rows are uniform; masked entries of other rows exactly 0
    np.testing.assert_allclose(g[[2, 8]], 1.0 / valid.shape[1], rtol=1e-2)
    live = valid.any(axis=1)
    assert (g[live][np.broadcast_to(~valid[live][:, None, None, :], g[live].shape)] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_softmax_vjp_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x32, valid = _dense_block(rng)
    dy32 = rng.normal(size=x32.shape).astype(np.float32)
    mask_j = jnp.asarray(valid)[:, None, None, :]
    x_j, dy_j = jnp.asarray(x32, JNP[dtype]), jnp.asarray(dy32, JNP[dtype])
    (want,) = jax.vjp(lambda x: fused_masked_softmax(x, mask_j, interpret=True), x_j)[1](dy_j)
    x_t = torch.from_numpy(x32).to(TORCH[dtype]).requires_grad_()
    fsm.masked_softmax(x_t, torch.from_numpy(valid)).backward(
        torch.from_numpy(dy32).to(TORCH[dtype]))
    assert x_t.grad.dtype == TORCH[dtype]
    np.testing.assert_allclose(_t32(x_t.grad), _f32(want), rtol=TOL[dtype]["rtol"], atol=1e-5)
    # masked entries of rows with a valid entry get no gradient (a fully
    # masked row is uniform, and its gradient is that of a uniform softmax)
    live = valid.any(axis=1)
    grad = _t32(x_t.grad)[live]
    assert (grad[np.broadcast_to(~valid[live][:, None, None, :], grad.shape)] == 0).all()


def test_wrappers_route_by_device_only():
    """A tensor on neither the CPU nor a CUDA device has no route."""
    x = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="no route"):
        fsm.segment_softmax(x, torch.zeros(4, dtype=torch.int32, device="meta"), 2)
    with pytest.raises(ValueError, match="no route"):
        fsm.masked_softmax(torch.zeros(1, 2, 2, device="meta"),
                           torch.ones(1, 2, device="meta"))


@pytest.mark.parametrize("op", ["segment_softmax", "masked_softmax"])
def test_backward_passes_gradcheck_in_fp64(op):
    """The autograd Functions' backwards (``s * (dy - sum(s * dy))``, B3's
    with one segment-sum launch) against finite differences, in fp64 (the
    plain versions take fp64 logits in fp64); an empty segment and a
    partly masked row included."""
    gen = torch.Generator().manual_seed(13)
    if op == "segment_softmax":
        ids = torch.tensor([3, 0, 0, 1, 3, 3, 1, 0, 4, 4], dtype=torch.int32)  # 2 empty
        x = torch.randn(10, 2, generator=gen, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(lambda x: fsm.segment_softmax(x, ids, 5), (x,))
    else:
        mask = torch.tensor([[1, 1, 1, 0], [1, 0, 1, 0]], dtype=torch.float64)
        x = torch.randn(2, 2, 3, 4, generator=gen, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(lambda x: fsm.masked_softmax(x, mask), (x,))
