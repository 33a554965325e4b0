"""Segment softmax and masked row softmax: the attention normalisations.

Counterpart of ``hydragnn_tpu/ops/fused_softmax.py``. Two kernels, both in
``csrc/segment_softmax.cu``, both fp32 inside with the output in the input's
type, both without atomics:

* :func:`segment_softmax` — per-segment softmax of ``[E, H]`` logits over
  segment ids (GAT's attention over each receiver's in-edges, self loop
  included; the Pallas ``_softmax_kernel``). A segment max that is not
  finite counts as 0 and the denominator is clamped at 1e-12, as in the
  JAX package's reference chain. The kernel reads the ids' CSR view
  (:class:`~hydragnn_tpu_torch.ops.fused_scatter.SegmentIndex`: its piece
  table and per-row tickets), the same 32-entry pieces as the
  segment-reduction kernels, in two launches per call.
* :func:`segment_softmax_stats` and :func:`segment_softmax_normalise` —
  the segment softmax in split form, for segments whose entries are spread
  over the ranks of the edge-sharded route: every row's per-column ``(M,
  S)`` over this rank's entries (``M`` the raw max, -inf for a row without
  entries here; ``S`` the sum of ``exp(x - M)``, ``M`` taken as 0 where not
  finite), then, after the ranks' statistics are combined
  (:func:`combine_softmax_stats`), ``exp(x - M) / max(S, 1e-12)`` over every
  entry. Two launches of the same kernel source as the fused softmax; at
  one rank they give its bits (:func:`split_segment_softmax`).
* :func:`masked_softmax` — ``softmax(where(mask > 0, x, -1e9))`` over the
  last axis of ``[G, ..., m]`` logits with a per-graph mask ``[G, m]``
  (GPS's dense per-graph attention blocks; the Pallas
  ``_row_softmax_kernel``). Fully masked rows come out uniform.

Routing is by device and nothing else, as in ``ops.fused_scatter``: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the plain
PyTorch version beside it. Launches count in ``fused_scatter.LAUNCHES``.

Both are differentiable through ``torch.autograd.Function``s whose
backward works from the saved output, as the JAX package's custom VJPs do
(neither backward is a Pallas kernel there):

* segment softmax: ``ds = s * (dy - segment_sum(s * dy)[ids])``, plain
  tensor code around ``fused_segment_sum`` (one launch of the segment-sum
  kernel over the same CSR view, counted as ``segment_sum``) and
  ``gather_rows``, both differentiable Functions of the port, so a second
  derivative stays on the kernels too;
* masked softmax: ``ds = s * (dy - sum_row(s * dy))``, plain tensor code;
  masked entries have ``s = 0`` and get no gradient.

Under ``torch.func.vmap`` both fold a population's members into one call
(the segment softmax into its heads, the masked softmax into the rows of
each graph), as ``ops.fused_scatter``'s Functions do.

:func:`cost` gives each kernel's FLOPs and bytes from its shapes, reported
to a counting cost ledger on either route and read by ``chip_smoke.py``
for the kernel table's bound.
"""

from __future__ import annotations

import torch

from ..telemetry.ledger import kernel_region
from .fused_scatter import (
    PIECE_EDGES,
    SegmentIndex,
    _check_cuda,
    _check_index,
    _count_launch,
    _dtype_code,
    _members_last,
    _raise_on,
    _route,
    _unbatched,
    accumulate_dtype,
    fused_segment_sum,
    gather_rows,
    segment_index,
)

# GAT's extended edge layout puts this many masked slots between the real
# edges and the appended self loops, so that the self-loop section starts on
# a multiple of 256 (the JAX package's softmax certificate block,
# ``SM_CERT_BLOCK``). The port keeps the same layout so that its arrays
# compare with the JAX model's index for index.
SM_CERT_BLOCK = 256
MASK_FILL = -1e9  # GPS's dense-attention mask fill, matched exactly
_DENOM_MIN = 1e-12


def self_loop_pad(num_edges: int) -> int:
    """Masked alignment slots GAT inserts after ``num_edges`` real edges."""
    return -num_edges % SM_CERT_BLOCK


# -- plain versions ----------------------------------------------------------


def plain_segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """The JAX package's reference chain (segment max, made 0 where not
    finite; exp of the shifted logits; segment sum clamped at 1e-12;
    divide), taken in fp32 (fp64 for fp64 logits) and cast back to
    ``logits.dtype``."""
    x = logits.detach().to(accumulate_dtype(logits.dtype))
    ids = segment_ids.long()
    shape = (num_segments, x.shape[1])
    seg_max = torch.zeros(shape, dtype=x.dtype, device=x.device).scatter_reduce_(
        0, ids[:, None].expand_as(x), x, reduce="amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    ex = torch.exp(x - seg_max[ids])
    denom = torch.zeros(shape, dtype=x.dtype, device=x.device).index_add_(0, ids, ex)
    return (ex / torch.clamp(denom, min=_DENOM_MIN)[ids]).to(logits.dtype)


def _finite_or_zero(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def plain_segment_softmax_stats(logits: torch.Tensor, segment_ids: torch.Tensor,
                                num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(M, S)``, each ``[num_segments, H]`` in fp32 (fp64 for fp64
    logits): the raw segment max (-inf for an empty segment) and the sum of
    ``exp(x - M)`` with ``M`` taken as 0 where not finite."""
    x = logits.detach().to(accumulate_dtype(logits.dtype))
    ids = segment_ids.long()
    shape = (num_segments, x.shape[1])
    seg_max = torch.full(shape, -float("inf"), dtype=x.dtype, device=x.device).scatter_reduce_(
        0, ids[:, None].expand_as(x), x, reduce="amax", include_self=False)
    ex = torch.exp(x - _finite_or_zero(seg_max)[ids])
    denom = torch.zeros(shape, dtype=x.dtype, device=x.device).index_add_(0, ids, ex)
    return seg_max, denom


def plain_segment_softmax_normalise(logits: torch.Tensor, segment_ids: torch.Tensor,
                                    seg_max: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """``exp(x - M) / max(S, 1e-12)`` per entry from its segment's
    statistics (``M`` taken as 0 where not finite), in fp32 (fp64 for fp64
    logits), cast back to ``logits.dtype``."""
    x = logits.detach().to(accumulate_dtype(logits.dtype))
    ids = segment_ids.long()
    ex = torch.exp(x - _finite_or_zero(seg_max.to(x.dtype))[ids])
    return (ex / torch.clamp(denom.to(x.dtype), min=_DENOM_MIN)[ids]).to(logits.dtype)


def combine_softmax_stats(seg_max: torch.Tensor, denom: torch.Tensor, reduce_max=None,
                          reduce_sum=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The ranks' statistics combined: ``M = max_r M_r`` (``reduce_max``),
    taken as 0 where not finite, and ``S = sum_r S_r exp(M_r - M)``
    (``reduce_sum``) over the ranks whose ``S_r > 0``, each ``M_r`` taken as
    0 where not finite as its ``S_r`` was (the fused kernel's combiner of a
    row's pieces). Without reducers, one rank's: ``M`` and ``S exp(0) = S``,
    so the fused softmax's bits. Tensors, no autograd."""
    m_all = seg_max if reduce_max is None else reduce_max(seg_max)
    shift = _finite_or_zero(m_all)
    part = torch.where(denom > 0, denom * torch.exp(_finite_or_zero(seg_max) - shift),
                       torch.zeros_like(denom))
    return shift, (part if reduce_sum is None else reduce_sum(part))


def _graph_mask(mask: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``[G, m]`` mask broadcast over the middle axes of ``[G, ..., m]``."""
    return mask.reshape((mask.shape[0],) + (1,) * (logits.dim() - 2) + (mask.shape[1],))


def plain_masked_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``softmax(where(mask > 0, logits, -1e9))`` over the last axis, in
    fp32 (fp64 for fp64 logits), cast back to ``logits.dtype``: max, exp,
    sum, divide."""
    x = torch.where(_graph_mask(mask, logits) > 0,
                    logits.detach().to(accumulate_dtype(logits.dtype)), MASK_FILL)
    ex = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return (ex / ex.sum(dim=-1, keepdim=True)).to(logits.dtype)


# -- cost ----------------------------------------------------------------------


def cost(kernel: str, *, rows: int, cols: int, itemsize: int = 4,
         mask_bytes: int = 0, segments: int = 0) -> tuple[int, int]:
    """``(flops, bytes)`` of one call: the logits ``[rows, cols]`` read and
    the output written once (``itemsize`` bytes an entry), and a max,
    subtract, exp, add and divide per entry. ``segment_softmax``: ``rows``
    entries of ``cols`` heads and their int32 segment ids; ``masked_softmax``:
    ``rows`` rows of ``cols`` entries and the ``mask_bytes`` of the
    one-byte-per-entry mask; ``segment_softmax_stats`` /
    ``segment_softmax_normalise``: the split form's two entries over
    ``rows`` entries and ``segments`` rows of statistics."""
    flops, logits = 5 * rows * cols, 2 * rows * cols * itemsize
    if kernel == "segment_softmax":
        return flops, logits + rows * 4
    if kernel == "masked_softmax":
        return flops, logits + mask_bytes
    # the split form: the statistics [segments, cols] fp32, written by the
    # first entry and read by the second; a max, subtract, exp and add per
    # entry, then a subtract, exp and divide
    stats = 2 * segments * cols * 4
    if kernel == "segment_softmax_stats":
        return 4 * rows * cols, rows * cols * itemsize + rows * 4 + stats
    if kernel == "segment_softmax_normalise":
        return 3 * rows * cols, logits + rows * 4 + stats
    raise ValueError(f"cost: unknown kernel {kernel!r}")


# -- wrappers ----------------------------------------------------------------


def _segment_args(name, logits, segment_ids, num_segments, index):
    """A segment softmax entry's checks on the card (the fused form's and
    the split form's); ``(dtype code, H, index)``, the index built where
    none was given."""
    _check_cuda(name, logits, segment_ids)
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits must be [E, H], got {tuple(logits.shape)}")
    code = _dtype_code(name, logits)
    e, h = logits.shape
    if segment_ids.shape[0] != e:
        raise ValueError(f"{name}: {e} rows but {segment_ids.shape[0]} ids")
    if index is None:
        index = segment_index(segment_ids, num_segments)
    _check_index(name, index, num_segments, e)
    return code, h, index


def _segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                     index: SegmentIndex | None) -> torch.Tensor:
    """One device-routed segment softmax (no autograd); its :func:`cost`
    goes to a counting ledger."""
    def shapes():
        return cost("segment_softmax", rows=logits.shape[0],
                    cols=logits.shape[1] if logits.dim() == 2 else 1,
                    itemsize=logits.element_size())

    with kernel_region("segment_softmax", shapes):
        return _segment_softmax_routed(logits, segment_ids, num_segments, index)


def _segment_softmax_routed(logits, segment_ids, num_segments, index):
    name = "segment_softmax"
    if not _route(name, logits):
        return plain_segment_softmax(logits, segment_ids, num_segments)
    code, h, index = _segment_args(name, logits, segment_ids, num_segments, index)
    logits = logits.contiguous()
    out = torch.empty_like(logits)
    scratch = torch.empty(2 * (index.max_pieces + num_segments) * h, dtype=torch.float32,
                          device=logits.device)
    from ._build import load

    status = load().segment_softmax_fwd(
        code, logits.data_ptr(), index.ptr.data_ptr(),
        index.piece_ptr.data_ptr(), index.piece_row.data_ptr(),
        index.perm.data_ptr() if index.perm is not None else None, out.data_ptr(),
        scratch.data_ptr(), index.tickets.data_ptr(), num_segments, index.max_pieces,
        PIECE_EDGES, h, torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _raise_on(name, status)
    _count_launch(name)
    return out


def _segment_softmax_stats(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                           index: SegmentIndex | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The first entry of the split form (no autograd); its :func:`cost`
    goes to a counting ledger."""
    name = "segment_softmax_stats"

    def shapes():
        return cost(name, rows=logits.shape[0], cols=logits.shape[1],
                    itemsize=logits.element_size(), segments=num_segments)

    with kernel_region(name, shapes):
        if not _route(name, logits):
            return plain_segment_softmax_stats(logits, segment_ids, num_segments)
        code, h, index = _segment_args(name, logits, segment_ids, num_segments, index)
        logits = logits.contiguous()
        stats = torch.empty((2, num_segments, h), dtype=torch.float32, device=logits.device)
        scratch = torch.empty(2 * index.max_pieces * h, dtype=torch.float32,
                              device=logits.device)
        from ._build import load

        status = load().segment_softmax_stats(
            code, logits.data_ptr(), index.ptr.data_ptr(), index.piece_ptr.data_ptr(),
            index.piece_row.data_ptr(),
            index.perm.data_ptr() if index.perm is not None else None,
            stats[0].data_ptr(), stats[1].data_ptr(), scratch.data_ptr(),
            index.tickets.data_ptr(), num_segments, index.max_pieces, PIECE_EDGES, h,
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
        _raise_on(name, status)
        _count_launch(name)
        return stats[0], stats[1]


def _segment_softmax_normalise(logits: torch.Tensor, segment_ids: torch.Tensor,
                               num_segments: int, shift: torch.Tensor, denom: torch.Tensor,
                               index: SegmentIndex | None) -> torch.Tensor:
    """The second entry of the split form (no autograd); its :func:`cost`
    goes to a counting ledger."""
    name = "segment_softmax_normalise"

    def shapes():
        return cost(name, rows=logits.shape[0], cols=logits.shape[1],
                    itemsize=logits.element_size(), segments=num_segments)

    with kernel_region(name, shapes):
        if not _route(name, logits):
            return plain_segment_softmax_normalise(logits, segment_ids, shift, denom)
        code, h, index = _segment_args(name, logits, segment_ids, num_segments, index)
        _check_cuda(name, logits, shift, denom)
        if tuple(shift.shape) != (num_segments, h) or tuple(denom.shape) != (num_segments, h):
            raise ValueError(f"{name}: statistics must be [{num_segments}, {h}], got "
                             f"{tuple(shift.shape)} and {tuple(denom.shape)}")
        logits = logits.contiguous()
        shift = shift.to(torch.float32).contiguous()
        denom = denom.to(torch.float32).contiguous()
        out = torch.empty_like(logits)
        from ._build import load

        status = load().segment_softmax_normalise(
            code, logits.data_ptr(), index.ptr.data_ptr(), index.piece_ptr.data_ptr(),
            index.piece_row.data_ptr(),
            index.perm.data_ptr() if index.perm is not None else None,
            shift.data_ptr(), denom.data_ptr(), out.data_ptr(), num_segments,
            index.max_pieces, PIECE_EDGES, h,
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
        _raise_on(name, status)
        _count_launch(name)
        return out


def _masked_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One device-routed masked row softmax (no autograd); its :func:`cost`
    goes to a counting ledger."""
    def shapes():
        m = logits.shape[-1]
        return cost("masked_softmax", rows=logits.numel() // m if m else 0, cols=m,
                    itemsize=logits.element_size(), mask_bytes=mask.numel())

    with kernel_region("masked_softmax", shapes):
        return _masked_softmax_routed(logits, mask)


def _masked_softmax_routed(logits, mask):
    name = "masked_softmax"
    if not _route(name, logits):
        return plain_masked_softmax(logits, mask)
    _check_cuda(name, logits, mask)
    code = _dtype_code(name, logits)
    if mask.dim() != 2 or logits.dim() < 2 or mask.shape[0] != logits.shape[0] \
            or mask.shape[1] != logits.shape[-1]:
        raise ValueError(
            f"{name}: mask must be [G, m] for logits [G, ..., m], got {tuple(mask.shape)} "
            f"for {tuple(logits.shape)}"
        )
    logits = logits.contiguous()
    m = logits.shape[-1]
    rows = logits.numel() // m if m else 0
    out = torch.empty_like(logits)
    # the kernel reads one byte per entry: GPS's validity mask is bool already
    valid = (mask if mask.dtype == torch.bool else mask > 0).contiguous()
    from ._build import load

    status = load().masked_softmax_fwd(
        code, logits.data_ptr(), valid.data_ptr(), out.data_ptr(), rows, m,
        max(rows // max(logits.shape[0], 1), 1),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _raise_on(name, status)
    _count_launch(name)
    return out


# -- autograd ----------------------------------------------------------------


class _SegmentSoftmax(torch.autograd.Function):
    """``s = segment_softmax(x)``; ``ds = s * (dy - segment_sum(s * dy)[ids])``
    in fp32 (fp64 for fp64), cast to the output's type (the JAX
    ``_fused_bwd``). Under ``torch.func.vmap`` the member axis folds into
    the heads, ``[E, M*H]``: one call for all members, each column
    normalised as it is alone."""

    @staticmethod
    def forward(logits, segment_ids, num_segments, index):
        return _segment_softmax(logits, segment_ids, num_segments, index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, segment_ids, num_segments, index = inputs
        ctx.num_segments = num_segments
        ctx.index = index
        ctx.save_for_backward(output, segment_ids)

    @staticmethod
    def vmap(info, in_dims, logits, segment_ids, num_segments, index):
        _unbatched("segment_softmax", in_dims, 1)
        m = info.batch_size
        lm = _members_last(logits, in_dims[0], m)  # [E, M, H]
        out = _SegmentSoftmax.apply(lm.reshape(lm.shape[0], -1), segment_ids, num_segments,
                                    index)
        return out.reshape(lm.shape), 1

    @staticmethod
    def backward(ctx, dout):
        out, segment_ids = ctx.saved_tensors
        s = out.to(accumulate_dtype(out.dtype))
        dy = dout.to(s.dtype)
        t = fused_segment_sum(s * dy, segment_ids, ctx.num_segments, ctx.index)
        ds = s * (dy - gather_rows(t, segment_ids, ctx.index))
        return ds.to(out.dtype), None, None, None


class _SplitSegmentSoftmax(torch.autograd.Function):
    """The segment softmax of this rank's entries of rows spread over a
    process group's ranks: statistics, their combine over the ranks, the
    normalisation. Its backward is the fused form's, with the segment sum
    of ``s * dy`` summed over the ranks (``comm.exit_sum``) before it is
    gathered back onto the entries."""

    @staticmethod
    def forward(logits, segment_ids, num_segments, index, group):
        from ..parallel import comm

        seg_max, denom = _segment_softmax_stats(logits, segment_ids, num_segments, index)
        shift, denom = combine_softmax_stats(
            seg_max, denom,
            lambda t: comm.reduce_tensor(t, group, "max"),
            lambda t: comm.reduce_tensor(t, group, "sum"))
        return _segment_softmax_normalise(logits, segment_ids, num_segments, shift, denom,
                                          index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, segment_ids, num_segments, index, group = inputs
        ctx.num_segments = num_segments
        ctx.index = index
        ctx.group = group
        ctx.save_for_backward(output, segment_ids)

    @staticmethod
    def backward(ctx, dout):
        from ..parallel.comm import exit_sum

        out, segment_ids = ctx.saved_tensors
        s = out.to(accumulate_dtype(out.dtype))
        dy = dout.to(s.dtype)
        t = exit_sum(fused_segment_sum(s * dy, segment_ids, ctx.num_segments, ctx.index),
                     ctx.group)
        ds = s * (dy - gather_rows(t, segment_ids, ctx.index))
        return ds.to(out.dtype), None, None, None, None


class _MaskedSoftmax(torch.autograd.Function):
    """``s = masked_softmax(x, mask)``; ``ds = s * (dy - sum_row(s * dy))`` in
    fp32 (fp64 for fp64), cast to the output's type (the JAX
    ``_fused_rows_bwd``). Under ``torch.func.vmap`` the member axis becomes
    the second axis of ``[G, M, ..., m]``, whose rows the per-graph mask
    covers as it covers the heads: one call for all members."""

    @staticmethod
    def forward(logits, mask):
        return _masked_softmax(logits, mask)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def vmap(info, in_dims, logits, mask):
        _unbatched("masked_softmax", in_dims, 1)
        return _MaskedSoftmax.apply(_members_last(logits, in_dims[0], info.batch_size),
                                    mask), 1

    @staticmethod
    def backward(ctx, dout):
        (out,) = ctx.saved_tensors
        s = out.to(accumulate_dtype(out.dtype))
        dy = dout.to(s.dtype)
        ds = s * (dy - (s * dy).sum(dim=-1, keepdim=True))
        return ds.to(out.dtype), None


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                    index: SegmentIndex | None = None) -> torch.Tensor:
    """Softmax of 2-D float ``logits`` ``[E, H]`` within each segment of
    ``segment_ids`` (per column); differentiable in ``logits``. ``index`` is
    the ids' :class:`SegmentIndex` where the caller caches one (GAT's
    self-loop receivers, ``GraphBatch.csr("loop_receivers")``); it is built
    when needed and not given."""
    return _SegmentSoftmax.apply(logits, segment_ids, num_segments, index)


def split_segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                          index: SegmentIndex | None = None, group=None) -> torch.Tensor:
    """:func:`segment_softmax` of this rank's entries when each segment's
    entries are spread over ``group``'s ranks (the edge-sharded route):
    :func:`segment_softmax_stats`, the ranks' statistics combined by one
    all-reduce of the maxima and one of the rescaled sums
    (:func:`combine_softmax_stats`), :func:`segment_softmax_normalise`.
    With one rank it gives :func:`segment_softmax`'s bits, forward and
    backward."""
    return _SplitSegmentSoftmax.apply(logits, segment_ids, num_segments, index, group)


def segment_softmax_stats(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                          index: SegmentIndex | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per segment and column of 2-D float ``logits`` ``[E, H]``: ``M``, the
    raw max (-inf for a segment without entries), and ``S``, the sum of
    ``exp(x - M)`` with ``M`` taken as 0 where not finite; fp32
    ``[num_segments, H]`` each, summed in the fused kernel's order. Not
    differentiable."""
    return _segment_softmax_stats(logits, segment_ids, num_segments, index)


def segment_softmax_normalise(logits: torch.Tensor, segment_ids: torch.Tensor,
                              num_segments: int, seg_max: torch.Tensor, denom: torch.Tensor,
                              index: SegmentIndex | None = None) -> torch.Tensor:
    """``exp(x - M) / max(S, 1e-12)`` for every entry of ``logits`` from its
    segment's statistics ``M``, ``S`` (``[num_segments, H]``; ``M`` taken as
    0 where not finite), in ``logits.dtype``. Not differentiable."""
    return _segment_softmax_normalise(logits, segment_ids, num_segments, seg_max, denom, index)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``softmax(where(mask > 0, logits, -1e9), axis=-1)`` of ``[G, ..., m]``
    float logits with the per-graph mask ``[G, m]``; differentiable in
    ``logits``."""
    return _MaskedSoftmax.apply(logits, mask)


__all__ = [
    "MASK_FILL",
    "SM_CERT_BLOCK",
    "combine_softmax_stats",
    "cost",
    "masked_softmax",
    "plain_masked_softmax",
    "plain_segment_softmax",
    "plain_segment_softmax_normalise",
    "plain_segment_softmax_stats",
    "segment_softmax",
    "segment_softmax_normalise",
    "segment_softmax_stats",
    "self_loop_pad",
    "split_segment_softmax",
]
