"""EXPERIMENTAL fp8 (e4m3 / e5m2) dense layer, the step below bf16.

Counterpart of ``hydragnn_tpu/ops/fp8_matmul.py``:

    y = (q8(x / s_x) · q8(w / s_w)) · (s_x ⊗ s_w) + b

with ``q8`` a saturating cast to ``torch.float8_e4m3fn`` (max 448) or
``torch.float8_e5m2`` (max 57344) after a clip to the format's largest
finite value, weights scaled per OUTPUT channel and activations per tensor.
Nothing routes through fp8 implicitly: callers opt in per matmul through
:func:`fp8_dense` and :func:`certify_fp8_dense`.

One kernel, ``csrc/fp8_matmul.cu`` (the fp8 format policy of the
tensor-core kernel in ``csrc/quant_mma.cuh``, which the int8 layer shares):
x's codes staged once per CTA, the fp8 products summed in fp32 by
``mma.sync`` m16n8k32 (within the summation-order bound of the exact sum,
on adversarial inputs too), dequantisation and bias in the epilogue. The activation scale is a tensor (computed from ``x`` on its
device unless given) and the kernel reads it through a device pointer, so
the call never waits for the host. Routing is by device and nothing else: a
CUDA tensor launches the kernel (or raises), a CPU tensor takes the plain
version (:func:`reference_fp8_dense`). Launches count in
``fused_scatter.LAUNCHES`` as ``fp8_dense``.

Weights are ``[K, N]``, the JAX package's layout at these functions.
Divisions are IEEE fp32 divisions by tensors on the operand's device, as in
``ops.quant_matmul``.

:func:`cost` gives the kernel's operations and bytes from its shapes,
reported to a counting cost ledger on either route and read by
``chip_smoke.py`` for the kernel table's bound.
"""

from __future__ import annotations

import torch

from ..telemetry.ledger import kernel_region
from .fused_scatter import _check_cuda, _count_launch, _raise_on, _route

FP8_FORMATS = {
    "e4m3": torch.float8_e4m3fn,
    "e5m2": torch.float8_e5m2,
}
# largest finite value per format (the saturating-clip bound before the cast)
FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}
_FORMAT_CODE = {"e4m3": 0, "e5m2": 1}


def resolve_fp8_format(fmt: str) -> torch.dtype:
    try:
        return FP8_FORMATS[fmt]
    except KeyError:
        raise ValueError(f"Unknown fp8 format {fmt!r}; one of {sorted(FP8_FORMATS)}") from None


def _scalar(v, device) -> torch.Tensor:
    """``v`` (a float or a tensor) as an fp32 0-d tensor on ``device``."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


def _quantize_fp8(x: torch.Tensor, fmt: str) -> torch.Tensor:
    # clip BEFORE the cast: e5m2 has inf, and an over-range cast would
    # manufacture it; the clip pins both formats to saturation
    bound = FP8_MAX[fmt]
    return torch.clamp(x.float(), -bound, bound).to(resolve_fp8_format(fmt))


def quantize_weight_fp8(w: torch.Tensor, fmt: str = "e4m3") -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel fp8 weight quantization of ``w [K, N]``: ``(w_q fp8
    [K, N], s_w fp32 [N])`` with ``w ≈ w_q · s_w``."""
    resolve_fp8_format(fmt)
    w = w.detach().float()
    s_w = torch.clamp(w.abs().amax(dim=0), min=1e-12) / _scalar(FP8_MAX[fmt], w.device)
    # row-major, as the kernel takes it: a transposed weight (the port's
    # Dense keeps [N, K]) would be copied at every call
    return _quantize_fp8(w / s_w[None, :], fmt).contiguous(), s_w


def activation_scale_fp8(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """Per-tensor activation scale (abs-max onto the format's range), an fp32
    0-d tensor on ``x``'s device."""
    return torch.clamp(x.detach().float().abs().amax(), min=1e-12) / _scalar(FP8_MAX[fmt],
                                                                             x.device)


def reference_fp8_parts(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, s_x,
                        bias: torch.Tensor | None, fmt: str = "e4m3"):
    """The plain version with its codes: ``(x_q fp8 [M, K], y fp32 [M, N])``.
    The fp8 products are summed in float64 and rounded to fp32 once, then
    ``acc * (s_x * s_w) + b`` is rounded once, as the kernel's FMA."""
    s_x = _scalar(s_x, x.device)
    x_q = _quantize_fp8(x.detach().float() / s_x, fmt)
    acc = (x_q.float().double() @ w_q.float().double()).float()
    y = acc.double() * (s_x * s_w.float()).double()[None, :]
    if bias is not None:
        y = y + bias.float().double()[None, :]
    return x_q, y.float()


def reference_fp8_dense(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, s_x,
                        bias: torch.Tensor | None, fmt: str = "e4m3") -> torch.Tensor:
    """The plain version: the JAX package's ``reference_fp8_dense``."""
    return reference_fp8_parts(x, w_q, s_w, s_x, bias, fmt)[1]


def cost(m: int, k: int, n: int, bias: bool = False) -> tuple[int, int]:
    """``(operations, bytes)`` of one call ``x [M, K] · W_q [K, N]``: a
    multiply and an add per product term, ``x`` read once as fp32 (the
    kernel stages fp32 rows), ``W_q`` (one byte an entry), the fp32 weight
    scales, bias and activation scale read, the fp32 output written."""
    return 2 * m * k * n, m * k * 4 + k * n + (2 if bias else 1) * n * 4 + 4 + m * n * 4


def _launch(x, w_q, s_w, s_x, bias, fmt: str, debug: bool):
    name = "fp8_dense"
    _check_cuda(name, x, w_q, s_w, s_x, bias)
    if x.dim() != 2 or w_q.dim() != 2 or w_q.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x must be [M, K] and w_q [K, N], got {tuple(x.shape)} and "
                         f"{tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    if w_q.dtype != FP8_FORMATS[fmt] or s_w.dtype != torch.float32 or s_w.shape != (n,):
        raise TypeError(f"{name}: w_q must be {FP8_FORMATS[fmt]} [K, N] and s_w float32 [N]")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"{name}: bias must be [N]")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    x_q = torch.empty((m, k), dtype=FP8_FORMATS[fmt], device=x.device) if debug else None
    if m == 0:
        return x_q, out
    x = x.float().contiguous()
    w_q, s_w = w_q.contiguous(), s_w.contiguous()
    bias = bias.float().contiguous() if bias is not None else None
    from ._build import load

    status = load().fp8_dense_fwd(
        _FORMAT_CODE[fmt], x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(), s_x.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        x_q.data_ptr() if debug else None, m, k, n,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(name, status)
    _count_launch(name)
    return x_q, out


def fp8_matmul_parts(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, s_x,
                     bias: torch.Tensor | None = None, fmt: str = "e4m3", debug: bool = False):
    """The routed product of quantized weights: the kernel for CUDA tensors
    (``debug`` also writes its fp8 codes of ``x``), the plain version for
    CPU ones. Returns ``(x_q or None, y)``."""
    resolve_fp8_format(fmt)
    with kernel_region("fp8_dense", lambda: cost(x.shape[0], x.shape[-1], w_q.shape[-1],
                                                 bias is not None)):
        if not _route("fp8_dense", x):
            x_q, y = reference_fp8_parts(x, w_q, s_w, s_x, bias, fmt)
            return (x_q if debug else None), y
        return _launch(x, w_q, s_w, _scalar(s_x, x.device), bias, fmt, debug)


def fp8_dense(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
              fmt: str = "e4m3", s_x=None) -> torch.Tensor:
    """Experimental fp8 dense layer ``[M, K] × [K, N] → fp32 [M, N]``:
    quantize the activations (per tensor; ``s_x`` a calibrated float or
    tensor, default derived from ``x`` on its device) and the weights (per
    output channel) to ``fmt``, multiply with fp32 accumulation, dequantize,
    add the bias."""
    w_q, s_w = quantize_weight_fp8(w, fmt)
    if s_x is None:
        s_x = activation_scale_fp8(x, fmt)
    return fp8_matmul_parts(x, w_q, s_w, s_x, bias, fmt)[1]


def certify_fp8_dense(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                      fmt: str = "e4m3") -> dict:
    """Measured error of :func:`fp8_dense` (the kernel on the card) against
    the fp32 product on this exact input: max-abs and relative-Frobenius
    error plus the format's structural parameters."""
    got = fp8_dense(x, w, bias, fmt)
    want = x.detach().float() @ w.detach().float()
    if bias is not None:
        want = want + bias.detach().float()
    diff = got - want
    denom = torch.clamp(torch.linalg.norm(want), min=1e-12)
    return {
        "format": fmt,
        "max_abs_err": float(diff.abs().max()),
        "rel_fro_err": float(torch.linalg.norm(diff) / denom),
        "mantissa_bits": 3 if fmt == "e4m3" else 2,
        "max_finite": FP8_MAX[fmt],
    }


__all__ = [
    "FP8_FORMATS",
    "FP8_MAX",
    "activation_scale_fp8",
    "certify_fp8_dense",
    "cost",
    "fp8_dense",
    "fp8_matmul_parts",
    "quantize_weight_fp8",
    "reference_fp8_dense",
    "reference_fp8_parts",
    "resolve_fp8_format",
]
