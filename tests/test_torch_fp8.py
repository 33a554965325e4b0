"""The port's experimental fp8 dense layer (``hydragnn_tpu_torch.ops.fp8_matmul``)
against the JAX package's (``hydragnn_tpu/ops/fp8_matmul.py``), on the CPU,
where ``fp8_dense`` takes its plain version.

For e4m3 and e5m2: the weight codes and scales and the activation scale
equal JAX's exactly; the activation codes ``x_q`` equal JAX's bit for bit;
``y`` lies within the summation-order bound ``K 2^-23 sum_k |x_q| |w_q|
s_x s_w`` (plus one rounding of ``y``) of the JAX reference and of the
Pallas kernel in interpret mode, since the fp8 products are exact in fp32
and only the order of the fp32 sum differs; saturation never makes an inf;
``certify_fp8_dense``'s numbers agree with JAX's.

The JAX reference is taken eagerly, as ``fp8_dense`` and
``certify_fp8_dense`` call it: on this XLA CPU build the jitted reference
with one output column (N = 1) fuses the clip, cast and dot into a result
that misses the exact product by up to 1.7 on a [64, 64] draw, which eager
JAX, the interpret-mode kernel at N >= 2 and the port do not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from hydragnn_tpu.ops import fp8_matmul as jf
from hydragnn_tpu_torch.ops import fp8_matmul as pf
from hydragnn_tpu_torch.ops import fused_scatter as fs

FORMATS = ["e4m3", "e5m2"]
# (M, K, N): a ragged row count, qm9's GIN layer 0 (K = 1), a head's output
# Dense (N = 1), the oc20 EGNN's first edge-MLP Dense width (K = 129)
SHAPES = [(37, 24, 16), (40, 1, 64), (33, 64, 1), (45, 129, 64)]


def _draw(shape, seed, scale=3.0):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32) * scale,
            rng.normal(size=(k, n)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


def _bytes(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8) if not isinstance(a, torch.Tensor) else \
        a.view(torch.uint8).numpy()


def _order_bound(x_q, w_q, s_x, s_w, y):
    """``K 2^-23 sum_k |x_q| |w_q| s_x s_w`` plus one ulp of ``|y|``."""
    k = x_q.shape[1]
    mag = np.abs(x_q.astype(np.float64)) @ np.abs(w_q.astype(np.float64))
    return k * 2.0 ** -23 * mag * float(s_x) * s_w[None, :] + np.spacing(np.abs(y))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fp8_plain_version_matches_jax(shape, fmt):
    x, w, b = _draw(shape, 0)
    jw_q, js_w = jf.quantize_weight_fp8(jnp.asarray(w), fmt)
    w_q, s_w = pf.quantize_weight_fp8(torch.from_numpy(w), fmt)
    assert w_q.dtype == pf.FP8_FORMATS[fmt]
    np.testing.assert_array_equal(_bytes(w_q), _bytes(jw_q))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(js_w))
    js_x = jf.activation_scale_fp8(jnp.asarray(x), fmt)
    s_x = pf.activation_scale_fp8(torch.from_numpy(x), fmt)
    assert float(s_x) == float(js_x)

    x_q, y = pf.reference_fp8_parts(torch.from_numpy(x), w_q, s_w, s_x, torch.from_numpy(b),
                                    fmt)
    jx_q = jf._quantize_fp8(jnp.asarray(x) / js_x, fmt, jf.FP8_FORMATS[fmt])
    np.testing.assert_array_equal(_bytes(x_q), _bytes(jx_q))

    got = y.numpy()
    xq32, wq32 = x_q.float().numpy(), w_q.float().numpy()
    wants = [np.asarray(jf.reference_fp8_dense(jnp.asarray(x), jw_q, js_w, js_x,
                                               jnp.asarray(b), fmt))]
    if shape[2] >= 2:
        wants.append(np.asarray(jf.fp8_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                             fmt, kernel=True, interpret=True)))
    for want in wants:
        bound = _order_bound(xq32, wq32, s_x, s_w.numpy(), want)
        assert np.all(np.abs(got - want) <= bound)
    assert np.isfinite(got).all()
    # fp8_dense itself (the router) on the CPU: the plain version, no launch
    before = dict(fs.LAUNCHES)
    routed = pf.fp8_dense(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), fmt)
    assert fs.LAUNCHES == before
    assert torch.equal(routed, y)


@pytest.mark.parametrize("fmt", FORMATS)
def test_fp8_saturation_never_makes_inf(fmt):
    """A calibrated ``s_x`` 1000x too small sends most of ``x / s_x`` past
    the format's range: the codes saturate at +-max (the JAX codes), the
    answer stays finite."""
    x, w, b = _draw((37, 24, 16), 1)
    js_x = jf.activation_scale_fp8(jnp.asarray(x), fmt) / 1000.0
    w_q, s_w = pf.quantize_weight_fp8(torch.from_numpy(w), fmt)
    s_x = torch.tensor(float(js_x))
    x_q, y = pf.reference_fp8_parts(torch.from_numpy(x), w_q, s_w, s_x, torch.from_numpy(b),
                                    fmt)
    jx_q = jf._quantize_fp8(jnp.asarray(x) / js_x, fmt, jf.FP8_FORMATS[fmt])
    np.testing.assert_array_equal(_bytes(x_q), _bytes(jx_q))
    codes = x_q.float()
    assert bool(torch.isfinite(codes).all()) and bool(torch.isfinite(y).all())
    assert float(codes.abs().max()) == pf.FP8_MAX[fmt]
    assert float((codes.abs() == pf.FP8_MAX[fmt]).float().mean()) > 0.5
    # an over-range weight column saturates too
    w_big = torch.from_numpy(w).clone()
    w_big[0, 0] = 1e30
    w_q2, _ = pf.quantize_weight_fp8(w_big, fmt)
    assert bool(torch.isfinite(w_q2.float()).all())


@pytest.mark.parametrize("fmt", FORMATS)
def test_certify_fp8_dense_matches_jax(fmt):
    x, w, b = _draw((45, 129, 64), 2)
    want = jf.certify_fp8_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), fmt)
    got = pf.certify_fp8_dense(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               fmt)
    assert got["format"] == want["format"] and got["max_finite"] == want["max_finite"]
    assert got["mantissa_bits"] == want["mantissa_bits"]
    # both answers differ from each other by the summation order only (~1e-5
    # of |y| ~ 30), and both fp32 products by theirs
    np.testing.assert_allclose(got["max_abs_err"], want["max_abs_err"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["rel_fro_err"], want["rel_fro_err"], rtol=1e-4)
    assert 0 < got["rel_fro_err"] < (0.06 if fmt == "e4m3" else 0.12)


def test_fp8_format_is_checked():
    with pytest.raises(ValueError, match="Unknown fp8 format"):
        pf.fp8_dense(torch.zeros(8, 4), torch.zeros(4, 2), fmt="e3m4")


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_weight_fp8_is_row_major(fmt):
    """The port's Dense keeps its weight as ``[N, K]``; quantized from the
    transposed view, the fp8 weight comes back row-major ``[K, N]`` (the
    kernel's layout, so the wrapper copies nothing per call) with the codes
    and scales of the contiguous weight, and JAX's."""
    _, w, _ = _draw((4, 24, 16), 3)
    view = torch.from_numpy(np.ascontiguousarray(w.T)).t()
    assert not view.is_contiguous()
    w_q, s_w = pf.quantize_weight_fp8(view, fmt)
    assert w_q.is_contiguous() and w_q.shape == (24, 16)
    c_q, c_s = pf.quantize_weight_fp8(torch.from_numpy(w), fmt)
    assert np.array_equal(_bytes(w_q), _bytes(c_q)) and torch.equal(s_w, c_s)
    jw_q, js_w = jf.quantize_weight_fp8(jnp.asarray(w), fmt)
    assert np.array_equal(_bytes(w_q), _bytes(jw_q))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(js_w))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", [(256, 64, 64), (256, 129, 64)], ids=str)
def test_fp8_adversarial_inputs_tell_a_14_bit_accumulator_from_fp32(shape, fmt):
    """The control of B7's adversarial gate in ``chip_smoke.py``, at the qm9
    and EGNN depths (``FP8_CONTROL_SHAPES``): on its inputs
    (``fp8_adversarial_inputs``, ``s_x = 1``), an fp32 accumulator in k order
    stays within the summation-order bound (``fp8_bound_ratio``), and a 14-bit
    one (``fp8_accumulator_emulation``) misses it, whether it carries the sum
    through k or is promoted to fp32 per 32-wide k step; the plain version
    (the CPU route) reads 0."""
    import chip_smoke

    assert shape in chip_smoke.FP8_CONTROL_SHAPES
    x, w = chip_smoke.fp8_adversarial_inputs(torch, fmt, *shape, torch.Generator().manual_seed(9))
    q = chip_smoke.fp8_quantized(torch, x, w, fmt, 1.0)

    def ratio(bits=None, promote=False):
        codes, r, _, _, finite = chip_smoke.fp8_bound_ratio(torch, x, *q, None, fmt, bits, promote)
        assert codes and finite
        return r

    assert ratio() == 0.0
    assert ratio(24) <= 1.0 and ratio(24, promote=True) <= 1.0
    assert ratio(14) > 1.0 and ratio(14, promote=True) > 1.0
