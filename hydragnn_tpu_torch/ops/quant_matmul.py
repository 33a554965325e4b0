"""Int8 dense layer of the quantized predict step (``serve.quant``).

Counterpart of ``hydragnn_tpu/ops/quant_matmul.py``. Every calibrated Dense
of the quantized step computes

    y = (q(x / s_x) · W_q) · (s_x ⊗ s_w) + b

with ``W_q`` the weight quantized symmetrically per OUTPUT channel
(:func:`quantize_weight`), ``s_x`` the layer's calibrated activation scale
(a Python float) and ``q`` round-half-to-even then clip to ±127. One kernel,
``csrc/quant_matmul.cu`` (the int8 format policy of the tensor-core kernel
in ``csrc/quant_mma.cuh``, which the fp8 layer shares): x quantized while it
is staged for the int8 tensor cores (``mma.sync`` m16n8k32), exact int32
accumulation, dequantisation and bias in the epilogue.

Routing is by device and nothing else: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain PyTorch version
(:func:`reference_quant_dense`). There is no flag, no row-block argument and
no fallback. Launches count in ``fused_scatter.LAUNCHES`` as
``quant_dense``.

The layout is the JAX package's at these functions: ``w_q`` is ``[K, N]``
(the port's ``Dense.weight`` is ``[N, K]``; ``serve.quant`` transposes).

Both routes compute the XLA route's arithmetic: ``x / s_x`` a true fp32
division (here by a tensor on ``x``'s device: PyTorch divides a CUDA tensor
by a Python scalar as a multiply by its reciprocal), exact int32 sums, the
fp32 product ``s_x * s_w`` and one rounding of ``acc * scale + b``, the FMA
the XLA CPU route fuses the dequantisation into (the plain version takes it
in float64 and rounds once).

:func:`cost` gives the kernel's operations and bytes from its shapes,
reported to a counting cost ledger on either route and read by
``chip_smoke.py`` for the kernel table's bound.
"""

from __future__ import annotations

import torch

from ..telemetry.ledger import kernel_region
from .fused_scatter import _check_cuda, _count_launch, _dtype_code, _raise_on, _route

QMAX = 127.0


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` as an IEEE division by an fp32 scalar on ``a``'s device."""
    return a / torch.full((), d, dtype=torch.float32, device=a.device)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 weight quantization of ``w [K, N]``:
    ``(w_q int8 [K, N], s_w fp32 [N])`` with ``w ≈ w_q · s_w``."""
    w = w.detach().float()
    s_w = _div(torch.clamp(w.abs().amax(dim=0), min=1e-12), QMAX)
    # row-major, as the kernel takes it: a transposed weight would be copied
    # at every call
    w_q = torch.clamp(torch.round(w / s_w[None, :]), -QMAX, QMAX).to(torch.int8).contiguous()
    return w_q, s_w


def quantize_acts(x: torch.Tensor, s_x: float) -> torch.Tensor:
    """``clip(round(x / s_x), -127, 127)`` as int8, ``x`` taken in fp32."""
    return torch.clamp(torch.round(_div(x.detach().float(), s_x)), -QMAX, QMAX).to(torch.int8)


def reference_quant_parts(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, s_x: float,
                          bias: torch.Tensor | None):
    """The plain version with its intermediates: ``(x_q int8 [M, K], acc
    int32 [M, N], y fp32 [M, N])``. The int8 products are summed in float64
    (exact for K below 2^38 / 127^2), so it runs on the card too."""
    x_q = quantize_acts(x, s_x)
    acc = (x_q.double() @ w_q.double()).to(torch.int32)
    scale = torch.full((), s_x, dtype=torch.float32, device=x.device) * s_w.float()
    y = acc.float().double() * scale.double()[None, :]
    if bias is not None:
        y = y + bias.float().double()[None, :]
    return x_q, acc, y.float()


def reference_quant_dense(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, s_x: float,
                          bias: torch.Tensor | None) -> torch.Tensor:
    """The plain version: the JAX package's ``reference_quant_dense``."""
    return reference_quant_parts(x, w_q, s_w, s_x, bias)[2]


def cost(m: int, k: int, n: int, itemsize: int = 4, bias: bool = False) -> tuple[int, int]:
    """``(operations, bytes)`` of one call ``x [M, K] · W_q [K, N]``: a
    multiply and an add per product term (int8), ``x`` read once
    (``itemsize`` bytes an entry), ``W_q`` (one byte an entry), the fp32
    scales and bias read, the fp32 output written."""
    return 2 * m * k * n, m * k * itemsize + k * n + (2 if bias else 1) * n * 4 + m * n * 4


def _region(x, w_q, bias):
    return kernel_region("quant_dense", lambda: cost(
        x.shape[0], x.shape[-1], w_q.shape[-1], x.element_size(), bias is not None))


def _launch(x, w_q, s_w, s_x, bias, debug: bool):
    name = "quant_dense"
    _check_cuda(name, x, w_q, s_w, bias)
    code = _dtype_code(name, x)
    if x.dim() != 2 or w_q.dim() != 2 or w_q.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x must be [M, K] and w_q [K, N], got {tuple(x.shape)} and "
                         f"{tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    if w_q.dtype != torch.int8 or s_w.dtype != torch.float32 or s_w.shape != (n,):
        raise TypeError(f"{name}: w_q must be int8 [K, N] and s_w float32 [N]")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,)):
        raise TypeError(f"{name}: bias must be float32 [N]")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    x_q = torch.empty((m, k), dtype=torch.int8, device=x.device) if debug else None
    acc = torch.empty((m, n), dtype=torch.int32, device=x.device) if debug else None
    if m == 0:
        return x_q, acc, out
    x, w_q, s_w = x.contiguous(), w_q.contiguous(), s_w.contiguous()
    bias = bias.contiguous() if bias is not None else None
    from ._build import load

    status = load().quant_dense_fwd(
        code, x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(),
        bias.data_ptr() if bias is not None else None, float(s_x), out.data_ptr(),
        x_q.data_ptr() if debug else None, acc.data_ptr() if debug else None, m, k, n,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(name, status)
    _count_launch(name)
    return x_q, acc, out


def quant_dense(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, s_x: float,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """Quantized dense layer ``[M, K] (fp32 or bf16) × int8 [K, N] → fp32
    [M, N]``: the kernel for CUDA tensors, the plain version for CPU ones."""
    with _region(x, w_q, bias):
        if not _route("quant_dense", x):
            return reference_quant_dense(x, w_q, s_w, s_x, bias)
        return _launch(x, w_q, s_w, s_x, bias, debug=False)[2]


def quant_dense_parts(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, s_x: float,
                      bias: torch.Tensor | None = None):
    """:func:`quant_dense` with its intermediates ``(x_q, acc, y)``: on a
    CUDA tensor one launch that also writes the kernel's int8 codes and
    int32 accumulators, for holding them against
    :func:`reference_quant_parts`."""
    with _region(x, w_q, bias):
        if not _route("quant_dense", x):
            return reference_quant_parts(x, w_q, s_w, s_x, bias)
        return _launch(x, w_q, s_w, s_x, bias, debug=True)


__all__ = [
    "cost",
    "quant_dense",
    "quant_dense_parts",
    "quantize_acts",
    "quantize_weight",
    "reference_quant_dense",
    "reference_quant_parts",
]
