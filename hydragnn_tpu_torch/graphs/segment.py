"""Segment reductions over padded batches.

Counterpart of ``hydragnn_tpu/graphs/segment.py``. ``segment_sum`` of float
data of two or more dimensions goes to the CSR segment-sum kernel wrapper
(``ops.fused_scatter.fused_segment_sum``), trailing axes flattened into
channels; ``segment_softmax`` goes to the segment-softmax kernel wrapper
(``ops.fused_softmax.segment_softmax``). Counts, 1-D reductions, max and min
stay plain PyTorch, as the JAX package leaves them to XLA.

Padding convention: padded elements carry the id of the trailing dummy
segment, so real segments are unaffected; empty segments give 0, and so do
max and min outputs that are not finite, as in the JAX package. The
edge-sharded route takes the extremes with the identity kept
(:func:`segment_extreme_raw`), reduces them over the ranks and only then
applies that rule (:func:`zero_empty`).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops import fused_softmax
from ..ops.fused_scatter import SegmentIndex, fused_segment_sum


def _flat_rows(data: torch.Tensor) -> torch.Tensor:
    """``[E, ...]`` as ``[E, C]``: the trailing axes as one channel axis."""
    return data.reshape(data.shape[0], -1)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                index: SegmentIndex | None = None) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` rows by ``segment_ids``.
    ``index`` is the ids' cached :class:`SegmentIndex` where the caller has
    one (``GraphBatch.csr``). Float data of more than two dimensions (GAT's
    ``[E, heads, F]`` messages) reaches the kernel as ``[E, heads * F]``."""
    if data.dim() >= 2 and data.is_floating_point():
        out = fused_segment_sum(_flat_rows(data), segment_ids, num_segments, index)
        return out.reshape((num_segments,) + tuple(data.shape[1:]))
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Number of (optionally weighted) elements per segment, [num_segments]."""
    if weights is None:
        weights = torch.ones(segment_ids.shape[0], dtype=torch.float32,
                             device=segment_ids.device)
    out = torch.zeros(num_segments, dtype=weights.dtype, device=weights.device)
    return out.index_add_(0, segment_ids.long(), weights)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 eps: float = 1e-12, index: SegmentIndex | None = None,
                 combine: Callable[[torch.Tensor], torch.Tensor] | None = None
                 ) -> torch.Tensor:
    """Mean per segment; empty segments give zeros. ``combine``, where
    given, maps the sums and the counts before the division (the
    edge-sharded route's sum over the ranks, ``models/common.py``)."""
    total = segment_sum(data, segment_ids, num_segments, index)
    count = segment_count(segment_ids, num_segments)
    if combine is not None:
        total, count = combine(total), combine(count)
    count = torch.clamp(count, min=eps).to(total.dtype)
    return total / count.reshape((-1,) + (1,) * (total.dim() - 1))


def segment_std(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                eps: float = 1e-5, index: SegmentIndex | None = None,
                combine: Callable[[torch.Tensor], torch.Tensor] | None = None
                ) -> torch.Tensor:
    """Biased standard deviation per segment, ``sqrt(max(E[x^2] - E[x]^2,
    0) + eps)`` from two :func:`segment_mean` (two segment-sum launches;
    ``combine`` as there); PNA's ``std`` aggregator."""
    mean = segment_mean(data, segment_ids, num_segments, index=index, combine=combine)
    mean_sq = segment_mean(data * data, segment_ids, num_segments, index=index,
                           combine=combine)
    v = mean_sq - mean * mean
    # torch.maximum, not clamp: at a tie (a segment of equal messages
    # cancels to v = 0) its gradient is 1/2, as jnp.maximum's; clamp's is 1
    var = torch.maximum(v, torch.zeros_like(v))
    return torch.sqrt(var + eps)


_EXTREMES = {
    "max": ("amax", lambda t: -math.inf if t.is_floating_point else torch.iinfo(t).min),
    "min": ("amin", lambda t: math.inf if t.is_floating_point else torch.iinfo(t).max),
}


def segment_extreme_raw(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                        kind: str = "max") -> torch.Tensor:
    """Max (``kind="max"``) or min per segment with the reduction's identity
    left in place: an empty segment gives -inf for the max, +inf for the
    min (the type's extreme for ints). The reduction starts from the
    identity, as ``jax.ops.segment_max``'s scatter does, so the gradient of
    a segment's extreme is split among the tied entries only: from a zeroed
    output, ``scatter_reduce_`` would count the output's own 0 among the
    ties of an extreme that is exactly 0. The edge-sharded route reduces
    these over the ranks before :func:`zero_empty` (``models/common.py``)."""
    reduce, identity = _EXTREMES[kind]
    out = torch.full((num_segments,) + tuple(data.shape[1:]), identity(data.dtype),
                     dtype=data.dtype, device=data.device)
    ids = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, ids, data, reduce=reduce, include_self=False)


def zero_empty(out: torch.Tensor, kind: str = "max") -> torch.Tensor:
    """The JAX package's rule (``graphs/segment.py::_zero_empty``): float
    outputs that are not finite become 0 (empty segments, and segments that
    met an inf or NaN), int outputs equal to the reduction's identity become
    0."""
    zero = torch.zeros_like(out)
    if out.is_floating_point():
        return torch.where(torch.isfinite(out), out, zero)
    return torch.where(out == _EXTREMES[kind][1](out.dtype), zero, out)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                index: SegmentIndex | None = None) -> torch.Tensor:
    """Max per segment; empty segments and non-finite maxima give 0."""
    return zero_empty(segment_extreme_raw(data, segment_ids, num_segments, "max"), "max")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                index: SegmentIndex | None = None) -> torch.Tensor:
    """Min per segment; empty segments and non-finite minima give 0."""
    return zero_empty(segment_extreme_raw(data, segment_ids, num_segments, "min"), "min")


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                    index: SegmentIndex | None = None) -> torch.Tensor:
    """Softmax within each segment, per trailing element (GAT's attention
    weights). Padded entries pointing at the dummy segment get finite values
    and must be masked by the caller."""
    out = fused_softmax.segment_softmax(_flat_rows(logits), segment_ids, num_segments, index)
    return out.reshape(logits.shape)


_POOL_FNS = {
    "add": segment_sum,
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
    "min": segment_min,
}


def global_pool(kind: str, data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, index: SegmentIndex | None = None) -> torch.Tensor:
    """Graph-level readout (``global_{mean,add,max,min}_pool``) as one
    segment reduction."""
    try:
        fn = _POOL_FNS[kind]
    except KeyError:
        raise ValueError(
            f"Unknown pooling '{kind}'; expected one of {sorted(_POOL_FNS)}"
        ) from None
    return fn(data, segment_ids, num_segments, index=index)


__all__ = [
    "global_pool",
    "segment_count",
    "segment_extreme_raw",
    "segment_max",
    "segment_mean",
    "segment_min",
    "segment_softmax",
    "segment_std",
    "segment_sum",
    "zero_empty",
]
