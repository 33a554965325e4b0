"""Gradients of the port's segment-reduction ops, its train-mode batch norm
and its masked losses, against the JAX package on the same numpy inputs.

The JAX side runs as its own tests run it on the CPU: the gather-scatter
through its Pallas path in interpret mode with the collate certificate
(``fused_gather_scatter(..., fits=True, interpret=True)``), whose custom VJP
launches the kernel again with senders and receivers swapped, and through
``reference_gather_scatter``; the port's autograd functions take their plain
versions on the CPU, forward and backward.

Tolerances: fp32 sums are taken in another order on the two sides, so fp32
compares at rtol 1e-5 / atol 1e-5, as the forward tests do; bf16 outputs are
sums rounded once to bf16 (2^-8 relative), so bf16 compares at rtol 1e-2 /
atol 1e-2, against the XLA reference taken in fp32 (in bf16 it rounds every
product and sum, ROADMAP queue C item 1). The input gradient is compared on real rows only: the JAX
kernel may leave the reserved dummy row N-1 different from its XLA route
(ROADMAP queue C item 2). Batch norm and losses are a few fp32 reductions
over at most a few hundred rows: rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from conftest import random_molecule_samples
from hydragnn_tpu.graphs.batching import collate, compute_pad_spec
from hydragnn_tpu.ops.fused_scatter import (
    fused_gather_scatter,
    fused_segment_sum,
    reference_gather_scatter,
)
from hydragnn_tpu_torch.ops import fused_scatter as fs

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SMALL_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def batch():
    """16 QM9-sized molecules in 472 node slots; receivers sorted, senders
    not, pad edges wired N-1 -> N-1 with mask 0."""
    samples = random_molecule_samples(16, seed=3)
    b = collate(samples, compute_pad_spec(samples, 16))
    assert b.x.shape[0] >= 256 and b.meta.gs_fits
    assert np.any(np.diff(b.senders) < 0), "the senders' view needs its permutation"
    return b


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


B1_CASES = [
    # (dtype, channels, weight kind, edge layout)
    ("float32", 64, "edge", "collated"),
    ("float32", 64, "channel", "collated"),
    ("float32", 1, "edge", "collated"),
    ("bfloat16", 1, "edge", "collated"),
    ("bfloat16", 64, "channel", "collated"),
    ("float32", 64, "edge", "unsorted"),
    ("float32", 64, "channel", "unsorted"),
]


@pytest.mark.parametrize("dtype,c,wkind,layout", B1_CASES)
def test_gather_scatter_vjp_matches_jax(batch, dtype, c, wkind, layout):
    """dh (the transposed launch) and dw, for [E] and [E, C] weights."""
    rng = np.random.default_rng(B1_CASES.index((dtype, c, wkind, layout)))
    n = batch.x.shape[0]
    s, r, m = batch.senders, batch.receivers, batch.edge_mask
    if layout == "unsorted":
        p = rng.permutation(s.shape[0])
        s, r, m = s[p], r[p], m[p]
    e = s.shape[0]
    h32 = rng.normal(size=(n, c)).astype(np.float32)
    w32 = (rng.uniform(0.5, 2.0, size=(e,) if wkind == "edge" else (e, c))
           * (m if wkind == "edge" else m[:, None])).astype(np.float32)
    dout32 = rng.normal(size=(n, c)).astype(np.float32)

    # the collate certificate holds for the collated layout only; a shuffled
    # edge list takes the JAX package's in-program fallback
    fits = True if layout == "collated" else None

    def pallas(h, w):
        return fused_gather_scatter(h, jnp.asarray(s), jnp.asarray(r), n, w, fits=fits,
                                    interpret=True)

    def reference(h, w):
        # the XLA route in fp32: in bf16 it rounds each w * dout product and
        # the sums to bf16 (ROADMAP queue C item 1), which neither the Pallas
        # kernel nor the port does
        f32 = jnp.float32
        return reference_gather_scatter(h.astype(f32), jnp.asarray(s), jnp.asarray(r), n,
                                        w.astype(f32)).astype(h.dtype)

    h_j, w_j = jnp.asarray(h32, JNP[dtype]), jnp.asarray(w32, JNP[dtype])
    dout_j = jnp.asarray(dout32, JNP[dtype])
    wants = [jax.vjp(f, h_j, w_j)[1](dout_j) for f in (pallas, reference)]

    h_t = torch.from_numpy(h32).to(TORCH[dtype]).requires_grad_()
    w_t = torch.from_numpy(w32).to(TORCH[dtype]).requires_grad_()
    before = dict(fs.LAUNCHES)
    out = fs.gather_scatter_sum(h_t, torch.from_numpy(s), torch.from_numpy(r), n, weight=w_t)
    out.backward(torch.from_numpy(dout32).to(TORCH[dtype]))
    assert fs.LAUNCHES == before, "the CPU route must not count kernel launches"
    assert h_t.grad.dtype == TORCH[dtype] and w_t.grad.dtype == TORCH[dtype]
    assert tuple(w_t.grad.shape) == w32.shape

    real = slice(0, n - 1)
    for dh_j, dw_j in wants:
        np.testing.assert_allclose(_t32(h_t.grad)[real], _f32(dh_j)[real], **TOL[dtype])
        np.testing.assert_allclose(_t32(w_t.grad), _f32(dw_j), **TOL[dtype])


def test_gather_scatter_backward_skips_what_needs_no_gradient(batch):
    """A weight without ``requires_grad`` gets no dw (GIN's edge mask), and
    an input without it gets no transposed launch (conv layer 0)."""
    n = batch.x.shape[0]
    s, r = torch.from_numpy(batch.senders), torch.from_numpy(batch.receivers)
    w = torch.from_numpy(batch.edge_mask)
    h = torch.randn(n, 8, requires_grad=True)
    fs.gather_scatter_sum(h, s, r, n, weight=w).sum().backward()
    assert h.grad is not None and w.grad is None
    w_g = w.clone().requires_grad_()
    fs.gather_scatter_sum(torch.randn(n, 8), s, r, n, weight=w_g).sum().backward()
    assert w_g.grad is not None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ids_kind", ["edges_to_nodes", "nodes_to_graphs"])
def test_segment_sum_vjp_matches_jax(batch, dtype, ids_kind):
    """The gradient of the segment sum is the gather dout[ids]."""
    rng = np.random.default_rng(9)
    n, g = batch.x.shape[0], batch.graph_mask.shape[0]
    ids, rows, segs = ((batch.receivers, batch.receivers.shape[0], n)
                       if ids_kind == "edges_to_nodes" else (batch.batch, n, g))
    data32 = rng.normal(size=(rows, 16)).astype(np.float32)
    dout32 = rng.normal(size=(segs, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda d: fused_segment_sum(d, jnp.asarray(ids), segs),
                     jnp.asarray(data32, JNP[dtype]))
    (want,) = vjp(jnp.asarray(dout32, JNP[dtype]))
    d_t = torch.from_numpy(data32).to(TORCH[dtype]).requires_grad_()
    fs.fused_segment_sum(d_t, torch.from_numpy(ids), segs).backward(
        torch.from_numpy(dout32).to(TORCH[dtype]))
    assert d_t.grad.dtype == TORCH[dtype]
    np.testing.assert_array_equal(_t32(d_t.grad), _f32(want))


# -- train-mode batch norm -----------------------------------------------------


@pytest.mark.parametrize("mask_kind", ["partial", "all_real", "zero_count"])
def test_masked_batch_norm_train_matches_jax(mask_kind):
    """Outputs, updated running statistics and gradients of the train-mode
    batch norm: count-weighted two-pass statistics, biased running variance,
    EMA weight 0.9 gated on real rows, running statistics for a batch
    without real rows."""
    from hydragnn_tpu.models.common import MaskedBatchNorm as JaxBN
    from hydragnn_tpu_torch.models.common import MaskedBatchNorm

    rng = np.random.default_rng(["partial", "all_real", "zero_count"].index(mask_kind))
    rows, feats = 96, 8
    x = (rng.normal(size=(rows, feats)) * 3.0 + 1.5).astype(np.float32)
    mask = {"partial": (rng.uniform(size=rows) < 0.6), "all_real": np.ones(rows, bool),
            "zero_count": np.zeros(rows, bool)}[mask_kind].astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=feats).astype(np.float32)
    bias = rng.normal(size=feats).astype(np.float32)
    ra_mean = rng.normal(scale=0.1, size=feats).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, size=feats).astype(np.float32)
    dy = rng.normal(size=(rows, feats)).astype(np.float32)

    bn = JaxBN()
    stats = {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}

    def apply(x_, scale_, bias_):
        return bn.apply({"params": {"scale": scale_, "bias": bias_}, "batch_stats": stats},
                        x_, jnp.asarray(mask), train=True, mutable=["batch_stats"])

    (y_j, upd), vjp = jax.vjp(apply, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    grads_j = vjp((jnp.asarray(dy), jax.tree.map(jnp.zeros_like, upd)))

    port = MaskedBatchNorm(feats)
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.mean.copy_(torch.from_numpy(ra_mean))
        port.var.copy_(torch.from_numpy(ra_var))
    x_t = torch.from_numpy(x).requires_grad_()
    y_t = port(x_t, torch.from_numpy(mask), train=True)
    y_t.backward(torch.from_numpy(dy))

    np.testing.assert_allclose(_t32(y_t), np.asarray(y_j), **SMALL_TOL)
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               **SMALL_TOL)
    np.testing.assert_allclose(port.var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               **SMALL_TOL)
    for got, want in zip((x_t.grad, port.scale.grad, port.bias.grad), grads_j):
        np.testing.assert_allclose(_t32(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    if mask_kind == "zero_count":
        # the running statistics are untouched, bit for bit
        np.testing.assert_array_equal(port.mean.numpy(), ra_mean)
        np.testing.assert_array_equal(port.var.numpy(), ra_var)
    assert port.mean.dtype == torch.float32


def test_masked_batch_norm_train_keeps_fp32_statistics_under_bf16():
    """bf16 input: the statistics are taken in bf16, the running buffers
    stay fp32, and the output promotes to fp32 as in the JAX package."""
    from hydragnn_tpu_torch.models.common import MaskedBatchNorm

    bn = MaskedBatchNorm(4)
    y = bn(torch.randn(16, 4).to(torch.bfloat16), torch.ones(16), train=True)
    assert y.dtype == torch.float32 and bn.mean.dtype == torch.float32
    assert bn.var.dtype == torch.float32 and bool((bn.mean != 0).any())


# -- masked losses -------------------------------------------------------------


@pytest.mark.parametrize("name", ["mse", "mae", "rmse", "smooth_l1"])
def test_masked_losses_match_jax(name):
    from hydragnn_tpu.models.common import get_loss as jax_get_loss
    from hydragnn_tpu_torch.models.common import get_loss

    rng = np.random.default_rng(3)
    pred = (rng.normal(size=(40, 3)) * 1.5).astype(np.float32)
    target = rng.normal(size=(40, 3)).astype(np.float32)
    mask = (rng.uniform(size=40) < 0.7).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jax_get_loss(name)(p, jnp.asarray(target), jnp.asarray(mask)),
                        jnp.asarray(pred))
    (want_grad,) = vjp(jnp.ones_like(want))
    p_t = torch.from_numpy(pred).requires_grad_()
    got = get_loss(name)(p_t, torch.from_numpy(target), torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **SMALL_TOL)
    np.testing.assert_allclose(_t32(p_t.grad), np.asarray(want_grad), **SMALL_TOL)
    # an all-padding batch divides by max(count, 1), not by zero
    zero = get_loss(name)(p_t, torch.from_numpy(target), torch.zeros(40))
    assert bool(torch.isfinite(zero)) and float(zero) == pytest.approx(
        1e-8 if name == "rmse" else 0.0, abs=1e-9)


def test_gaussian_nll_waits_for_variance_outputs():
    """GaussianNLLLoss came with the variance outputs: ``get_loss`` gives
    the masked Gaussian NLL, equal to the JAX package's on the same arrays
    (``tests/test_torch_heads.py`` holds its gradients); an unknown loss
    still raises."""
    from hydragnn_tpu.models.common import masked_gaussian_nll as jax_nll
    from hydragnn_tpu_torch.models.common import get_loss

    rng = np.random.default_rng(0)
    pred, target, var = rng.normal(size=(3, 12, 2)).astype(np.float32)
    var = var * var
    mask = (np.arange(12) < 9).astype(np.float32)
    got = get_loss("GaussianNLLLoss")(*(torch.from_numpy(a) for a in (pred, target, mask, var)))
    want = jax_nll(*(jnp.asarray(a) for a in (pred, target, mask, var)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="Unknown loss"):
        get_loss("huber")
