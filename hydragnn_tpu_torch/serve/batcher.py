"""Dynamic bucketed micro-batching for the serving tier.

Counterpart of ``hydragnn_tpu/serve/batcher.py``. Coalesces in-flight
requests into the tightest ``PadSpec`` bucket of the endpoint's table (the
same table training derives) under a max-latency flush timer: the first
request of a batch opens a ``flush_ms`` window; requests arriving inside it
join until the batch would overflow the top bucket or hit the graph-slot
cap.

Every served batch of a bucket carries the bucket's canonical per-graph node
bound (:func:`canonical_meta`), whatever its contents, and requests above
that bound are shed. Unlike the JAX package, the sortedness certificates are
real per batch (collate checks them host-side): the CSR kernels have no
compile cache for a certificate to invalidate, and on the card every served
batch runs the kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Sequence

from ..graphs.batching import PadSpec, collate, pick_bucket
from ..graphs.graph import BatchMeta, GraphBatch, GraphSample
from .admission import DeadlineExceededError, OversizeError, Request, RequestQueue


@functools.lru_cache(maxsize=256)
def _canonical_meta_cached(key: tuple, node_cap: int | None) -> BatchMeta:
    if node_cap:
        bound = node_cap
    else:
        bound = max(1 << max(key[0] - 1, 0).bit_length(), 8)
    return BatchMeta(max_n_node=int(bound))


def canonical_meta(pad: PadSpec) -> BatchMeta:
    """The bucket's canonical meta: ``max_n_node`` is the dataset-wide
    per-graph cap when known, else the power-of-two ceiling of the bucket's
    node slots. The sortedness fields are left unknown; ``serving_collate``
    fills them from the batch."""
    return _canonical_meta_cached(pad.as_tuple(), pad.node_cap)


def serving_collate(samples: Sequence[GraphSample], pad: PadSpec) -> GraphBatch:
    """``graphs.batching.collate`` with the bucket's canonical node bound —
    the only collate the serving tier runs."""
    batch = collate(samples, pad)
    return batch.replace(
        meta=dataclasses.replace(batch.meta, max_n_node=canonical_meta(pad).max_n_node)
    )


# how long before a member's deadline the coalescing window closes, so the
# batch dispatches (and passes the dispatch-time expiry re-check) in time
_DISPATCH_MARGIN_S = 0.002


def _totals(sample: GraphSample) -> tuple[int, int, int]:
    t = sample.extras["idx_kj"].shape[0] if "idx_kj" in sample.extras else 0
    return sample.num_nodes, sample.num_edges, t


class MicroBatcher:
    """Forms (requests, bucket) batches from a :class:`RequestQueue`; one
    per endpoint, consumed by that endpoint's dispatcher thread. It owns no
    locks: shared state is the queue's, reached through its locked methods.

    Policy, for each batch:

    1. Block for the first live request (expired ones fail fast with
       :class:`DeadlineExceededError`).
    2. A request that alone fits no bucket is shed with :class:`OversizeError`.
    3. Admit requests until the flush window closes, the batch holds
       ``max_graphs`` requests, or the next request would overflow the top
       bucket (it goes back to the queue head for the next batch).
    4. Collate to the tightest bucket that fits the totals.
    """

    def __init__(self, queue: RequestQueue, buckets: Sequence[PadSpec], flush_s: float,
                 max_graphs: int = 0, on_shed=None):
        self.queue = queue
        self.buckets = sorted(buckets, key=lambda p: p.as_tuple())
        self.flush_s = max(0.0, float(flush_s))
        cap = max(b.n_graph - 1 for b in self.buckets)
        self.max_graphs = min(int(max_graphs), cap) if max_graphs > 0 else cap
        # per-bucket node bound: a batch may only collate to a bucket whose
        # bound covers its largest member
        self._bounds = {b.as_tuple(): canonical_meta(b).max_n_node for b in self.buckets}
        self.node_bound = max(self._bounds.values())
        self.on_shed = on_shed or (lambda kind: None)

    def _pick(self, tot_n: int, tot_e: int, tot_t: int, n_graphs: int,
              max_member_n: int) -> PadSpec | None:
        bounded = [b for b in self.buckets if self._bounds[b.as_tuple()] >= max_member_n]
        return pick_bucket(bounded, tot_n, tot_e, tot_t, n_graphs)

    def _admissible(self, req: Request) -> bool:
        """Shed expired requests and requests no bucket can hold even alone
        (counted "cancelled" when the client's own cancel won the race)."""
        if req.expired():
            kind = "deadline" if req.reject(DeadlineExceededError(
                "deadline passed while queued"
            )) else "cancelled"
            self.on_shed(kind)
            return False
        n, e, t = _totals(req.sample)
        if self._pick(n, e, t, 1, n) is None:
            kind = "oversize" if req.reject(OversizeError(
                f"sample ({n} nodes, {e} edges, {t} triplets) fits no serving bucket "
                f"of this endpoint (largest {self.buckets[-1]!r}, per-graph node "
                f"bound {self.node_bound})"
            )) else "cancelled"
            self.on_shed(kind)
            return False
        return True

    def _first_live(self, block: bool) -> Request | None:
        while True:
            req = self.queue.get(timeout=None if block else 0.25)
            if req is None:
                return None
            if self._admissible(req):
                return req

    def next_batch(self, block: bool = False) -> tuple[list[Request], PadSpec] | None:
        """The next dispatchable micro-batch, or ``None`` if the queue shut
        down (``block=True``) or stayed empty past the poll."""
        first = self._first_live(block)
        if first is None:
            return None
        members = [first]
        tot_n, tot_e, tot_t = _totals(first.sample)
        max_n = first.sample.num_nodes
        flush_at = time.monotonic() + self.flush_s
        if first.deadline is not None:
            flush_at = min(flush_at, first.deadline - _DISPATCH_MARGIN_S)
        while len(members) < self.max_graphs:
            remaining = flush_at - time.monotonic()
            if remaining <= 0:
                break
            req = self.queue.get(timeout=remaining)
            if req is None:
                break
            if not self._admissible(req):
                continue
            n, e, t = _totals(req.sample)
            if self._pick(tot_n + n, tot_e + e, tot_t + t, len(members) + 1,
                          max(max_n, n)) is None:
                self.queue.push_back(req)
                break
            members.append(req)
            tot_n, tot_e, tot_t = tot_n + n, tot_e + e, tot_t + t
            max_n = max(max_n, n)
            if req.deadline is not None:
                flush_at = min(flush_at, req.deadline - _DISPATCH_MARGIN_S)
        pad = self._pick(tot_n, tot_e, tot_t, len(members), max_n)
        assert pad is not None  # every admitted member kept the batch viable
        return members, pad


__all__ = ["MicroBatcher", "canonical_meta", "serving_collate"]
