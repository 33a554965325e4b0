"""Gather→scale→scatter-add and segment-sum: the message-passing hot ops.

Counterpart of ``hydragnn_tpu/ops/fused_scatter.py``. Two kernels, one
template in ``csrc/segment_reduce.cu``, both a CSR segmented reduction in
one launch (one warp per 32-edge piece of a row, fp32 accumulation, no
atomics on data):

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

Both are differentiable to any order through ``torch.autograd.Function``s.
Every backward is built from these Functions themselves (or plain
differentiable tensor code), never from a raw launch, so the gradient of a
gradient (forces trained through their parameter gradient) stays on the
kernels on the card, without atomics, and on the plain versions on the CPU:

* the gradient of ``gather_scatter_sum`` with respect to ``h`` is
  :func:`gather_scatter_sum_bwd`, the same Function with senders and
  receivers swapped, over the senders' CSR view (the Pallas ``_fused_bwd``
  launches ``_kernel`` again the same way), and the gradient of that is
  ``gather_scatter_sum`` again; the weight's gradient ``dw[e] = <h[s_e], dout[r_e]>`` is
  tensor code over two :func:`gather_rows`, as the JAX package leaves it to
  XLA;
* the gradient of ``fused_segment_sum`` is the gather ``dout[ids]``, taken
  by :func:`gather_rows` (no launch; the JAX package takes it in XLA);
* the gradient of :func:`gather_rows` is ``fused_segment_sum`` of ``dout``
  by the ids.

The launches count by entry point: a transposed gather-scatter as
``gather_scatter_sum_bwd``, a segment sum as ``segment_sum``. First derivatives launch exactly what they launched when
the backwards called the launchers directly.

Under ``torch.func.vmap`` (a population's members, ``train/population.py``)
each Function's batching rule folds the member axis into the channels and
makes one call for all members, whose backward is again one call: a
population step launches each kernel as often as one member's step. The
ids (senders, receivers, segment ids) are shared; a batched id array
raises.

:func:`cost` gives each kernel's FLOPs and bytes from its shapes. Every
call reports it, on either route, to the telemetry plane's cost ledger
when one counts the step (``telemetry.ledger.kernel_region``), and
``chip_smoke.py`` computes the kernel table's bound from it: one count,
two readers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from ..telemetry.ledger import kernel_region

# Launches of each kernel of the package since the last reset, counted where
# the wrapper launches it (the CPU route does not count); the softmax kernels
# of ``ops.fused_softmax``, the cell-list kernel of ``ops.fused_cell_list``
# (once per build, for its count and write launches) and the quantized dense
# kernels of ``ops.quant_matmul`` and ``ops.fp8_matmul`` count here too.
# ``gather_scatter_sum_bwd`` counts the gather-scatter kernel's transposed
# launches from the backward, which ``gather_scatter_sum`` does not.
# Dispatcher threads of several served models may launch at once, so updates
# hold the lock. A launch on the stream of a CUDA-graph capture
# (``capture.py``), from whichever thread (autograd runs backwards on its
# own), counts into that capture's record instead, which every replay of
# the graph adds here (:func:`add_launches`).
LAUNCHES = {"gather_scatter_sum": 0, "gather_scatter_sum_bwd": 0, "segment_sum": 0,
            "segment_softmax": 0, "segment_softmax_stats": 0, "segment_softmax_normalise": 0,
            "masked_softmax": 0, "cell_list": 0, "quant_dense": 0, "fp8_dense": 0}
_LAUNCHES_LOCK = threading.Lock()
_SINKS: dict = {}  # guarded-by: _LAUNCHES_LOCK; CUDA stream handle -> counts

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    """Count one launch on the current stream (called right after it)."""
    stream = torch.cuda.current_stream().cuda_stream if _SINKS else None
    with _LAUNCHES_LOCK:
        _SINKS.get(stream, LAUNCHES)[name] += 1


def add_launches(counts: dict) -> None:
    """Add ``counts`` (one replay's record of a captured graph) to
    :data:`LAUNCHES`."""
    with _LAUNCHES_LOCK:
        for k, v in counts.items():
            LAUNCHES[k] += v


@contextlib.contextmanager
def launch_sink(stream):
    """Inside, launches on the CUDA ``stream`` count into the yielded dict,
    not into :data:`LAUNCHES`: a graph capture records what one replay
    launches, and the warm-up runs before it, whose effects the capture
    undoes, count nowhere."""
    counts = dict.fromkeys(LAUNCHES, 0)
    with _LAUNCHES_LOCK:
        _SINKS[stream.cuda_stream] = counts
    try:
        yield counts
    finally:
        with _LAUNCHES_LOCK:
            del _SINKS[stream.cuda_stream]


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
    shapes alone, and ``piece_row[p]`` is piece ``p``'s row
    (``num_segments`` past the last piece), so a kernel warp finds its row
    in one load. ``tickets`` is the segment-sum kernel's per-row counter
    that elects the block combining a row of several pieces: 0 between
    launches (each launch puts back what it takes), so calls over one index
    must be ordered on one stream, as every caller's are (a batch belongs to
    one step or one dispatcher). int32 throughout."""

    ptr: torch.Tensor  # [num_segments + 1]
    piece_ptr: torch.Tensor  # [num_segments + 1]
    piece_row: torch.Tensor  # [max_pieces]
    tickets: torch.Tensor  # [num_segments]
    perm: torch.Tensor | None  # [E] stable sort permutation, or None
    num_segments: int
    num_ids: int  # E, the length of the id array it was built from
    max_pieces: int


def segment_index(ids: torch.Tensor, num_segments: int,
                  is_sorted: bool | None = None) -> SegmentIndex:
    """Row pointer, piece pointer, piece -> row table, zeroed tickets and
    (unless ``is_sorted``) the stable sort permutation of ``ids``.
    ``is_sorted=None`` means unknown: the ids are argsorted, which leaves
    sorted ids in place. Nothing here waits for the device."""
    num_segments = int(num_segments)
    ids = ids.to(torch.int32).contiguous()
    perm = None
    sorted_ids = ids
    if not is_sorted:
        perm = torch.argsort(ids, stable=True)
        sorted_ids = ids[perm]
        perm = perm.to(torch.int32)
    # sum over rows of max(1, ceil(len / P)) <= num_segments + ceil(E / P)
    max_pieces = num_segments + -(-ids.shape[0] // PIECE_EDGES)
    # one arange serves as the row bounds and the piece ids
    ar = torch.arange(max(max_pieces, num_segments + 1), device=ids.device, dtype=torch.int32)
    ptr = torch.searchsorted(sorted_ids, ar[: num_segments + 1], out_int32=True)
    pieces = torch.clamp((ptr[1:] - ptr[:-1] + PIECE_EDGES - 1) // PIECE_EDGES, min=1)
    # the piece pointer and the tickets share one zeroed buffer
    zeros = torch.zeros(2 * num_segments + 1, dtype=torch.int32, device=ids.device)
    piece_ptr, tickets = zeros[: num_segments + 1], zeros[num_segments + 1:]
    piece_ptr[1:] = torch.cumsum(pieces, 0, dtype=torch.int32)
    # the row of piece p: the number of rows whose pieces end at or before p
    piece_row = torch.searchsorted(piece_ptr[1:], ar[:max_pieces], right=True,
                                   out_int32=True)
    return SegmentIndex(ptr=ptr.contiguous(), piece_ptr=piece_ptr, piece_row=piece_row,
                        tickets=tickets, perm=perm, num_segments=num_segments,
                        num_ids=int(ids.shape[0]), max_pieces=max_pieces)


# -- plain versions ----------------------------------------------------------


def accumulate_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type sums and softmax statistics are taken in: fp32 for fp32 and
    narrower inputs (the JAX package's and the kernels'), fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


def plain_gather_scatter_sum(h: torch.Tensor, senders: torch.Tensor,
                             receivers: torch.Tensor, num_nodes: int,
                             weight: torch.Tensor | None = None) -> torch.Tensor:
    """Gather, scale, ``index_add_`` in fp32 (fp64 for fp64 ``h``), cast
    back to ``h.dtype``."""
    acc = accumulate_dtype(h.dtype)
    msgs = h.index_select(0, senders.long()).to(acc)
    if weight is not None:
        w = weight if weight.dim() == 2 else weight[:, None]
        msgs = msgs * w.to(acc)
    out = torch.zeros((num_nodes, h.shape[1]), dtype=acc, device=h.device)
    out.index_add_(0, receivers.long(), msgs)
    return out.to(h.dtype)


def plain_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """``index_add_`` of ``data`` rows in fp32 (fp64 for fp64 ``data``),
    cast back to ``data.dtype``."""
    acc = accumulate_dtype(data.dtype)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=acc, device=data.device)
    out.index_add_(0, segment_ids.long(), data.to(acc))
    return out.to(data.dtype)


# -- cost ----------------------------------------------------------------------


def cost(kernel: str, *, rows: int, cols: int, ids: int, out_rows: int, itemsize: int = 4,
         weight: str | None = None) -> tuple[int, int]:
    """``(flops, bytes)`` of one call: each input read once, each output
    written once. ``gather_scatter_sum`` (either direction): ``h [rows,
    cols]`` read, the sender and receiver ids (int32) of the ``ids`` edges,
    the weight (``"edge"``: fp32 ``[E]``, ``"channel"``: fp32 ``[E, cols]``),
    ``out [out_rows, cols]`` written; a multiply and an add per edge and
    channel (an add without a weight). ``segment_sum``: ``data [rows, cols]``
    and its ``rows`` ids read, ``out [out_rows, cols]`` written; an add per
    entry. ``itemsize``: the bytes of one feature (4 fp32, 2 bf16)."""
    feats = (rows + out_rows) * cols * itemsize
    if kernel == "segment_sum":
        return rows * cols, feats + rows * 4
    if kernel not in ("gather_scatter_sum", "gather_scatter_sum_bwd"):
        raise ValueError(f"cost: unknown kernel {kernel!r}")
    w_bytes = {None: 0, "edge": ids * 4, "channel": ids * cols * 4}[weight]
    return (2 if weight else 1) * ids * cols, feats + 2 * ids * 4 + w_bytes


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
    tensors, counted under ``counter``; the plain version for CPU tensors.
    Its :func:`cost` goes to a counting ledger under ``counter``."""
    def shapes():
        w = None if weight is None else ("channel" if weight.dim() == 2 else "edge")
        return cost(counter, rows=h.shape[0], cols=h.shape[-1], ids=senders.shape[0],
                    out_rows=num_nodes, itemsize=h.element_size(), weight=w)

    with kernel_region(counter, shapes):
        return _gather_scatter_routed(h, senders, receivers, num_nodes, weight, index, counter)


def _gather_scatter_routed(h, senders, receivers, num_nodes, weight, index, counter):
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
        w_mode, index.ptr.data_ptr(), index.piece_ptr.data_ptr(), index.piece_row.data_ptr(),
        index.perm.data_ptr() if index.perm is not None else None,
        out.data_ptr(), partial.data_ptr(), index.tickets.data_ptr(), num_nodes,
        index.max_pieces, PIECE_EDGES, c, torch.cuda.current_stream(h.device).cuda_stream,
    )
    _raise_on(name, status)
    _count_launch(counter)
    return out


def _segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 index: SegmentIndex | None) -> torch.Tensor:
    """One device-routed segment sum (no autograd); its :func:`cost` goes to
    a counting ledger."""
    def shapes():
        cols = data.shape[1] if data.dim() == 2 else 1
        return cost("segment_sum", rows=data.shape[0], cols=cols, ids=data.shape[0],
                    out_rows=num_segments, itemsize=data.element_size())

    with kernel_region("segment_sum", shapes):
        return _segment_sum_routed(data, segment_ids, num_segments, index)


def _segment_sum_routed(data, segment_ids, num_segments, index):
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
        index.piece_row.data_ptr(), index.perm.data_ptr() if index.perm is not None else None,
        out.data_ptr(), partial.data_ptr(), index.tickets.data_ptr(), num_segments,
        index.max_pieces, PIECE_EDGES, c, torch.cuda.current_stream(data.device).cuda_stream,
    )
    _raise_on(name, status)
    _count_launch(name)
    return out


# -- autograd ----------------------------------------------------------------


def _unbatched(name: str, in_dims, *which: int) -> None:
    """A batching rule's refusal of a batched index input: a population
    shares its batch (``train/population.py``), so senders, receivers and
    segment ids never carry the member axis."""
    if any(in_dims[i] is not None for i in which):
        raise ValueError(f"{name}: a batched index input (senders, receivers or segment ids) "
                         "has no batching rule; members must share the batch")


def _members_last(x: torch.Tensor | None, dim, size: int) -> torch.Tensor | None:
    """``x`` with the member axis (at ``dim``, or broadcast when None) moved
    after the row axis: ``[rows, M, ...]``."""
    if x is None:
        return None
    if dim is None:
        return x.unsqueeze(1).expand(x.shape[0], size, *x.shape[1:])
    return x.movedim(dim, 1)


class _GatherScatterSum(torch.autograd.Function):
    """``out = gather_scatter_sum(h, ...)`` with the JAX package's VJP
    (``_fused_bwd``): ``dh`` is the same Function over the transposed graph
    (so its own gradient is this one again), ``dw[e] = <h[s_e], dout[r_e]>``.
    ``counter`` names the entry point and its launch count:
    ``gather_scatter_sum`` or the transposed ``gather_scatter_sum_bwd``.

    Under ``torch.func.vmap`` (a population's members, ``h [M, n, C]``) the
    batching rule folds the member axis into the channels, ``[n, M*C]``,
    and makes one call for all members; a weight batched per edge takes
    the per-channel ``[E, M*C]`` form. Every channel sums its edges in the
    order it does alone, so a member's output is the one it gets alone."""

    @staticmethod
    def forward(h, weight, senders, receivers, num_nodes, index, send_index, counter):
        return _gather_scatter(h, senders, receivers, num_nodes, weight, index, counter)

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, weight, senders, receivers, num_nodes, index, send_index, counter = inputs
        ctx.num_nodes = num_nodes
        # the rows of h, which the transposed launch writes: the output's
        # rows on one device; under edge sharding DimeNet's triplets read
        # every rank's edges and write this rank's
        ctx.h_rows = h.shape[0]
        ctx.index = index
        ctx.send_index = send_index
        ctx.counter = counter
        ctx.h_dtype = h.dtype
        # h is read back only for the weight's gradient
        need_dw = weight is not None and ctx.needs_input_grad[1]
        ctx.save_for_backward(h if need_dw else None, weight, senders, receivers)

    @staticmethod
    def vmap(info, in_dims, h, weight, senders, receivers, num_nodes, index, send_index,
             counter):
        _unbatched(counter, in_dims, 2, 3)
        m = info.batch_size
        h_dim, w_dim = in_dims[0], in_dims[1]
        hm = _members_last(h, h_dim, m)  # [n, M, C]
        c = hm.shape[-1]
        if weight is not None and (w_dim is not None or weight.dim() == 2):
            w = _members_last(weight, w_dim, m)  # [E, M] or [E, M, C]
            if w.dim() == 2:
                w = w.unsqueeze(-1).expand(*w.shape, c)
            weight = w.reshape(w.shape[0], m * c)
        out = _GatherScatterSum.apply(hm.reshape(hm.shape[0], m * c), weight, senders,
                                      receivers, num_nodes, index, send_index, counter)
        return out.reshape(out.shape[0], m, c), 1

    @staticmethod
    def backward(ctx, dout):
        h, weight, senders, receivers = ctx.saved_tensors
        dh = dw = None
        if ctx.needs_input_grad[0]:
            # the JAX package casts dout to h's dtype first (fused_scatter.py:306)
            g = dout.to(ctx.h_dtype)
            if ctx.counter == "gather_scatter_sum":
                dh = gather_scatter_sum_bwd(g, senders, receivers, ctx.h_rows, weight,
                                            send_index=ctx.send_index, index=ctx.index)
            else:  # the transpose of the transposed application
                dh = gather_scatter_sum(g, receivers, senders, ctx.h_rows, weight,
                                        index=ctx.send_index, send_index=ctx.index)
        if h is not None:
            acc = accumulate_dtype(h.dtype)
            hs = gather_rows(h, senders, ctx.send_index).to(acc)
            dr = gather_rows(dout, receivers, ctx.index).to(acc)
            dw = hs * dr if weight.dim() == 2 else (hs * dr).sum(dim=-1)
            dw = dw.to(weight.dtype)
        return dh, dw, None, None, None, None, None, None


class _SegmentSum(torch.autograd.Function):
    """``out = fused_segment_sum(data, ...)``; the gradient is ``dout[ids]``,
    a :func:`gather_rows` whose own gradient is this Function again. Under
    ``torch.func.vmap`` the member axis folds into the columns: one call
    for all members."""

    @staticmethod
    def forward(data, segment_ids, num_segments, index):
        return _segment_sum(data, segment_ids, num_segments, index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        data, segment_ids, num_segments, index = inputs
        ctx.save_for_backward(segment_ids)
        ctx.index = index

    @staticmethod
    def vmap(info, in_dims, data, segment_ids, num_segments, index):
        _unbatched("segment_sum", in_dims, 1)
        m = info.batch_size
        dm = _members_last(data, in_dims[0], m)  # [E, M, C]
        out = _SegmentSum.apply(dm.reshape(dm.shape[0], -1), segment_ids, num_segments, index)
        return out.reshape(out.shape[0], m, *dm.shape[2:]), 1

    @staticmethod
    def backward(ctx, dout):
        (segment_ids,) = ctx.saved_tensors
        return gather_rows(dout, segment_ids, ctx.index), None, None, None


class _GatherRows(torch.autograd.Function):
    """``out = x[ids]``; the gradient is ``fused_segment_sum(dout, ids)``,
    one device-routed segment-sum launch over ``index``, whose own gradient
    is this Function again. Under ``torch.func.vmap`` the rows of all
    members are gathered at once (``x [rows, M, ...]``), and the gradient
    is one segment sum over their folded columns."""

    @staticmethod
    def forward(x, ids, index):
        return x.index_select(0, ids.long())

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ids, index = inputs
        ctx.save_for_backward(ids)
        ctx.num_rows = x.shape[0]
        ctx.index = index

    @staticmethod
    def vmap(info, in_dims, x, ids, index):
        _unbatched("gather_rows", in_dims, 1)
        return _GatherRows.apply(_members_last(x, in_dims[0], info.batch_size), ids, index), 1

    @staticmethod
    def backward(ctx, dout):
        (ids,) = ctx.saved_tensors
        rows = dout.reshape(dout.shape[0], -1)
        dx = fused_segment_sum(rows, ids, ctx.num_rows, ctx.index)
        return dx.reshape((ctx.num_rows,) + tuple(dout.shape[1:])), None, None


def gather_rows(x: torch.Tensor, ids: torch.Tensor,
                index: SegmentIndex | None = None) -> torch.Tensor:
    """``x[ids]`` (rows of float ``x``), differentiable in ``x``: the
    gradient sums ``dout`` rows by ``ids`` with the segment-sum kernel over
    ``index``, the ids' :class:`SegmentIndex` (built when needed and not
    given). Autograd's own backward of a gather is an ``index_put_`` or
    ``index_add_`` that CUDA runs as a sort walking duplicate ids one by one
    or as atomics whose order varies between runs; GAT gathers ~11.5k
    entries of the dummy node, and its training is to be reproducible."""
    return _GatherRows.apply(x, ids, index)


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
                                   send_index, "gather_scatter_sum")


def gather_scatter_sum_bwd(dout: torch.Tensor, senders: torch.Tensor,
                           receivers: torch.Tensor, num_nodes: int,
                           weight: torch.Tensor | None = None,
                           send_index: SegmentIndex | None = None,
                           index: SegmentIndex | None = None) -> torch.Tensor:
    """The gradient of :func:`gather_scatter_sum` with respect to ``h``:
    ``segment_sum(weight * dout[receivers], senders, num_nodes)``, the same
    kernel launched over the transposed graph (the senders' CSR view
    ``send_index``, built when not given), counted as
    ``gather_scatter_sum_bwd``. :func:`gather_scatter_sum`'s backward runs
    this; it is differentiable in ``dout`` and ``weight`` in turn, its
    gradient with respect to ``dout`` running over ``index``, the
    receivers' view."""
    return _GatherScatterSum.apply(dout, weight, receivers, senders, num_nodes, send_index,
                                   index, "gather_scatter_sum_bwd")


def fused_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                      index: SegmentIndex | None = None) -> torch.Tensor:
    """Sum the rows of 2-D float ``data`` into ``num_segments`` rows by
    ``segment_ids`` (fp32 accumulation, output in ``data.dtype``);
    differentiable in ``data``."""
    return _SegmentSum.apply(data, segment_ids, num_segments, index)


__all__ = [
    "LAUNCHES",
    "SegmentIndex",
    "accumulate_dtype",
    "add_launches",
    "cost",
    "fused_segment_sum",
    "gather_rows",
    "gather_scatter_sum",
    "gather_scatter_sum_bwd",
    "launch_sink",
    "plain_gather_scatter_sum",
    "plain_segment_sum",
    "reset_launches",
    "segment_index",
]
