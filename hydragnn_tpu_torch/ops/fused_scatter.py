"""Gather→scale→scatter-add and segment-sum: the message-passing hot ops.

Counterpart of ``hydragnn_tpu/ops/fused_scatter.py``. Two kernels, both in
``csrc/segment_reduce.cu``, both a CSR segmented reduction (one warp per
output row, fp32 accumulation, no atomics):

* :func:`gather_scatter_sum` — ``out[r] = sum_e w[e] * h[s[e]]`` over the
  edges with receiver ``r`` (the Pallas ``_kernel``);
* :func:`fused_segment_sum` — ``out[r] = sum_e data[e]`` over the rows with
  segment id ``r`` (the Pallas ``_scatter_kernel``).

Routing is by device and nothing else: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain PyTorch version beside it. There
is no flag and no fallback from the kernel to the plain version.

The kernels read a row pointer over sorted ids (:class:`SegmentIndex`),
built once per batch and id array and cached on the port's ``GraphBatch``.
Ids that collate did not certify as sorted get a stable argsort, whose
permutation the kernel follows.

Both are differentiable through ``torch.autograd.Function``s whose forward
and backward call the same device-routed launches, so on the CPU the
backward formulas run through the plain versions:

* the gradient of ``gather_scatter_sum`` with respect to ``h`` is the same
  kernel with senders and receivers swapped, over the senders' CSR view (the
  Pallas ``_fused_bwd`` launches ``_kernel`` again the same way); the
  weight's gradient ``dw[e] = <h[s_e], dout[r_e]>`` is plain tensor code,
  as the JAX package leaves it to XLA;
* the gradient of ``fused_segment_sum`` is the gather ``dout[ids]``
  (``index_select``; the JAX package takes it in XLA, with no kernel).
"""

from __future__ import annotations

import dataclasses
import threading

import torch

# Launches of each kernel since the last reset, counted where the wrapper
# launches it (the CPU route does not count). ``gather_scatter_sum_bwd``
# counts the gather-scatter kernel's transposed launches from the backward,
# which ``gather_scatter_sum`` does not. Dispatcher threads of several served
# models may launch at once, so updates hold the lock.
LAUNCHES = {"gather_scatter_sum": 0, "gather_scatter_sum_bwd": 0, "segment_sum": 0}
_LAUNCHES_LOCK = threading.Lock()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


# Edges per piece: the kernels cut every row into pieces of this many edges,
# counted from the row's own first edge, and give each piece one warp. Rows
# of a molecular batch have at most ``max_neighbours`` (20 for QM9) edges,
# so each real row is one piece summed in plain edge order; only the
# reserved dummy row, which owns every pad edge, spans many pieces.
PIECE_EDGES = 32


@dataclasses.dataclass(frozen=True)
class SegmentIndex:
    """CSR view of an id array, as the kernels read it. The rows with id
    ``r`` are ``perm[ptr[r]:ptr[r+1]]`` (``perm`` None: the ids are sorted
    and the rows are ``ptr[r]..ptr[r+1]`` themselves). Row ``r`` owns the
    kernel pieces ``piece_ptr[r]..piece_ptr[r+1]`` (at least one, so an
    empty row is written too); ``max_pieces`` bounds their total from the
    shapes alone. int32 throughout."""

    ptr: torch.Tensor  # [num_segments + 1]
    piece_ptr: torch.Tensor  # [num_segments + 1]
    perm: torch.Tensor | None  # [E] stable sort permutation, or None
    num_segments: int
    num_ids: int  # E, the length of the id array it was built from
    max_pieces: int


def segment_index(ids: torch.Tensor, num_segments: int,
                  is_sorted: bool | None = None) -> SegmentIndex:
    """Row pointer, piece pointer and (unless ``is_sorted``) the stable sort
    permutation of ``ids``. ``is_sorted=None`` means unknown: the ids are
    argsorted, which leaves sorted ids in place. Nothing here waits for the
    device."""
    ids = ids.to(torch.int32).contiguous()
    perm = None
    sorted_ids = ids
    if not is_sorted:
        perm = torch.argsort(ids, stable=True)
        sorted_ids = ids[perm]
        perm = perm.to(torch.int32)
    bounds = torch.arange(num_segments + 1, device=ids.device, dtype=torch.int32)
    ptr = torch.searchsorted(sorted_ids, bounds, out_int32=True)
    pieces = torch.clamp((ptr[1:] - ptr[:-1] + PIECE_EDGES - 1) // PIECE_EDGES, min=1)
    piece_ptr = torch.zeros(num_segments + 1, dtype=torch.int32, device=ids.device)
    piece_ptr[1:] = torch.cumsum(pieces, 0, dtype=torch.int32)
    # sum over rows of max(1, ceil(len / P)) <= num_segments + ceil(E / P)
    max_pieces = int(num_segments) + -(-ids.shape[0] // PIECE_EDGES)
    return SegmentIndex(ptr=ptr.contiguous(), piece_ptr=piece_ptr, perm=perm,
                        num_segments=int(num_segments), num_ids=int(ids.shape[0]),
                        max_pieces=max_pieces)


# -- plain versions ----------------------------------------------------------


def plain_gather_scatter_sum(h: torch.Tensor, senders: torch.Tensor,
                             receivers: torch.Tensor, num_nodes: int,
                             weight: torch.Tensor | None = None) -> torch.Tensor:
    """Gather, scale, ``index_add_`` in fp32, cast back to ``h.dtype``."""
    msgs = h.index_select(0, senders.long()).float()
    if weight is not None:
        w = weight if weight.dim() == 2 else weight[:, None]
        msgs = msgs * w.float()
    out = torch.zeros((num_nodes, h.shape[1]), dtype=torch.float32, device=h.device)
    out.index_add_(0, receivers.long(), msgs)
    return out.to(h.dtype)


def plain_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """``index_add_`` of ``data`` rows in fp32, cast back to ``data.dtype``."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=torch.float32,
                      device=data.device)
    out.index_add_(0, segment_ids.long(), data.float())
    return out.to(data.dtype)


# -- wrappers ----------------------------------------------------------------


def _check_cuda(name: str, first: torch.Tensor, *tensors: torch.Tensor) -> None:
    for t in (first, *tensors):
        if t is None:
            continue
        if t.device != first.device:
            raise ValueError(
                f"{name}: all inputs must be on {first.device}, got one on {t.device}"
            )


def _route(name: str, t: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    tensor); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no route for tensors on {t.device} (cuda or cpu only)")


def _dtype_code(name: str, t: torch.Tensor) -> int:
    try:
        return _DTYPE_CODE[t.dtype]
    except KeyError:
        raise TypeError(
            f"{name}: the CUDA kernel takes float32 or bfloat16, got {t.dtype}"
        ) from None


def _raise_on(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")


def _check_index(name: str, index: SegmentIndex, num_segments: int, num_ids: int) -> None:
    if (index.num_segments, index.num_ids) != (num_segments, num_ids):
        raise ValueError(
            f"{name}: index built for {index.num_ids} ids into {index.num_segments} rows, "
            f"called with {num_ids} ids into {num_segments} rows"
        )


def _gather_scatter(h: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
                    num_nodes: int, weight: torch.Tensor | None, index: SegmentIndex | None,
                    counter: str) -> torch.Tensor:
    """One device-routed gather-scatter (no autograd): the kernel for CUDA
    tensors, counted under ``counter``; the plain version for CPU tensors."""
    name = "gather_scatter_sum"
    if not _route(name, h):
        return plain_gather_scatter_sum(h, senders, receivers, num_nodes, weight)
    _check_cuda(name, h, senders, receivers, weight)
    if h.dim() != 2:
        raise ValueError(f"{name}: h must be [N, C], got {tuple(h.shape)}")
    code = _dtype_code(name, h)
    c = h.shape[1]
    e = senders.shape[0]
    if receivers.shape[0] != e:
        raise ValueError(f"{name}: {e} senders but {receivers.shape[0]} receivers")
    w_mode = 0
    w = None
    if weight is not None:
        if weight.dim() == 1 and weight.shape[0] == e:
            w_mode = 1
        elif weight.dim() == 2 and tuple(weight.shape) == (e, c):
            w_mode = 2
        else:
            raise ValueError(
                f"{name}: weight must be [E] or [E, C] = [{e}] or [{e}, {c}], got "
                f"{tuple(weight.shape)}"
            )
        w = weight.to(torch.float32).contiguous()
    if index is None:
        index = segment_index(receivers, num_nodes)
    _check_index(name, index, num_nodes, e)
    h = h.contiguous()
    s = senders.to(torch.int32).contiguous()
    out = torch.empty((num_nodes, c), dtype=h.dtype, device=h.device)
    partial = torch.empty((index.max_pieces, c), dtype=torch.float32, device=h.device)
    from ._build import load

    lib = load()
    status = lib.gather_scatter_sum_fwd(
        code, h.data_ptr(), s.data_ptr(), w.data_ptr() if w is not None else None,
        w_mode, index.ptr.data_ptr(), index.piece_ptr.data_ptr(),
        index.perm.data_ptr() if index.perm is not None else None,
        out.data_ptr(), partial.data_ptr(), num_nodes, index.max_pieces, PIECE_EDGES, c,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _raise_on(name, status)
    _count_launch(counter)
    return out


def _segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 index: SegmentIndex | None) -> torch.Tensor:
    """One device-routed segment sum (no autograd)."""
    name = "segment_sum"
    if not _route(name, data):
        return plain_segment_sum(data, segment_ids, num_segments)
    _check_cuda(name, data, segment_ids)
    if data.dim() != 2:
        raise ValueError(f"{name}: data must be [E, C], got {tuple(data.shape)}")
    code = _dtype_code(name, data)
    if segment_ids.shape[0] != data.shape[0]:
        raise ValueError(f"{name}: {data.shape[0]} rows but {segment_ids.shape[0]} ids")
    if index is None:
        index = segment_index(segment_ids, num_segments)
    _check_index(name, index, num_segments, data.shape[0])
    data = data.contiguous()
    c = data.shape[1]
    out = torch.empty((num_segments, c), dtype=data.dtype, device=data.device)
    partial = torch.empty((index.max_pieces, c), dtype=torch.float32, device=data.device)
    from ._build import load

    lib = load()
    status = lib.segment_sum_fwd(
        code, data.data_ptr(), index.ptr.data_ptr(), index.piece_ptr.data_ptr(),
        index.perm.data_ptr() if index.perm is not None else None,
        out.data_ptr(), partial.data_ptr(), num_segments, index.max_pieces, PIECE_EDGES, c,
        torch.cuda.current_stream(data.device).cuda_stream,
    )
    _raise_on(name, status)
    _count_launch(name)
    return out


# -- autograd ----------------------------------------------------------------


class _GatherScatterSum(torch.autograd.Function):
    """``out = gather_scatter_sum(h, ...)`` with the JAX package's VJP
    (``_fused_bwd``): ``dh`` is the same op over the transposed graph,
    ``dw[e] = <h[s_e], dout[r_e]>``."""

    @staticmethod
    def forward(ctx, h, weight, senders, receivers, num_nodes, index, send_index):
        out = _gather_scatter(h, senders, receivers, num_nodes, weight, index,
                              "gather_scatter_sum")
        ctx.num_nodes = num_nodes
        ctx.send_index = send_index
        ctx.h_dtype = h.dtype
        # h is read back only for the weight's gradient
        need_dw = weight is not None and ctx.needs_input_grad[1]
        ctx.save_for_backward(h if need_dw else None, weight, senders, receivers)
        return out

    @staticmethod
    def backward(ctx, dout):
        h, weight, senders, receivers = ctx.saved_tensors
        dh = dw = None
        if ctx.needs_input_grad[0]:
            # the JAX package casts dout to h's dtype first (fused_scatter.py:306)
            dh = gather_scatter_sum_bwd(dout.to(ctx.h_dtype), senders, receivers,
                                        ctx.num_nodes, weight, ctx.send_index)
        if h is not None:
            hs = h.index_select(0, senders.long()).float()
            dr = dout.index_select(0, receivers.long()).float()
            dw = hs * dr if weight.dim() == 2 else (hs * dr).sum(dim=-1)
            dw = dw.to(weight.dtype)
        return dh, dw, None, None, None, None, None


class _SegmentSum(torch.autograd.Function):
    """``out = fused_segment_sum(data, ...)``; the gradient is ``dout[ids]``."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, index):
        ctx.save_for_backward(segment_ids)
        return _segment_sum(data, segment_ids, num_segments, index)

    @staticmethod
    def backward(ctx, dout):
        (segment_ids,) = ctx.saved_tensors
        return dout.index_select(0, segment_ids.long()), None, None, None


def gather_scatter_sum(h: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
                       num_nodes: int, weight: torch.Tensor | None = None,
                       index: SegmentIndex | None = None,
                       send_index: SegmentIndex | None = None) -> torch.Tensor:
    """``segment_sum(weight * h[senders], receivers, num_nodes)``,
    differentiable in ``h`` and ``weight``.

    ``index``: the receivers' :class:`SegmentIndex` (``GraphBatch.csr``
    caches it per batch); ``send_index``: the senders' one, which the
    gradient with respect to ``h`` runs over. Each is built when needed and
    not given. ``weight`` is per edge ``[E]`` or per edge and channel
    ``[E, C]``. Receivers outside ``[0, num_nodes)`` are dropped; senders must
    index rows of ``h`` (collate guarantees both, and the card does not check
    senders)."""
    return _GatherScatterSum.apply(h, weight, senders, receivers, num_nodes, index,
                                   send_index)


def gather_scatter_sum_bwd(dout: torch.Tensor, senders: torch.Tensor,
                           receivers: torch.Tensor, num_nodes: int,
                           weight: torch.Tensor | None = None,
                           send_index: SegmentIndex | None = None) -> torch.Tensor:
    """The gradient of :func:`gather_scatter_sum` with respect to ``h``:
    ``segment_sum(weight * dout[receivers], senders, num_nodes)``, the same
    kernel launched over the transposed graph (the senders' CSR view
    ``send_index``, built when not given), counted as
    ``gather_scatter_sum_bwd``."""
    return _gather_scatter(dout, receivers, senders, num_nodes, weight, send_index,
                           "gather_scatter_sum_bwd")


def fused_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                      index: SegmentIndex | None = None) -> torch.Tensor:
    """Sum the rows of 2-D float ``data`` into ``num_segments`` rows by
    ``segment_ids`` (fp32 accumulation, output in ``data.dtype``);
    differentiable in ``data``."""
    return _SegmentSum.apply(data, segment_ids, num_segments, index)


__all__ = [
    "LAUNCHES",
    "SegmentIndex",
    "fused_segment_sum",
    "gather_scatter_sum",
    "gather_scatter_sum_bwd",
    "plain_gather_scatter_sum",
    "plain_segment_sum",
    "reset_launches",
    "segment_index",
]
