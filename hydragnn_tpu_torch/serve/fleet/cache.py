"""Content-addressed answer cache for the fleet router.

Counterpart of ``hydragnn_tpu/serve/fleet/cache.py``, with the same keys:
SHA-256 over the canonicalized graph bytes, the model name and the quant
flag. Canonicalization is the wire codec (``utils.wire``): the sample's
arrays, key-sorted, packed with their dtype and shape, so the same molecule
gives the same bytes whatever the dict order or array contiguity, and any
difference in any value gives other bytes. The key of a sample here equals
the JAX package's key of the same sample.

The cache is a byte-budgeted LRU: an entry is charged its per-head array
bytes plus its key, and inserts evict from the cold end until the budget
holds. ``put`` and ``get`` copy, so a hit stays byte-identical to replica
compute whatever callers do to their arrays.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np

from ...graphs.graph import GraphSample
from ...utils import wire


def canonical_sample_bytes(sample: GraphSample) -> bytes:
    """The content-address preimage of one graph: its wire arrays in
    sorted key order (``pack_arrays`` covers name + dtype + shape + raw
    bytes per array, so any difference in any field changes the bytes)."""
    return wire.pack_arrays(dict(sorted(wire.sample_to_arrays(sample).items())))


def answer_key(sample: GraphSample, model: str, quantized: bool = False) -> str:
    """Digest of (canonical graph bytes, model name, quant flag). The
    quant flag is part of the address: an int8 answer and an fp32 answer
    for the same graph are DIFFERENT answers, and a fleet that flips
    quantization must never serve stale cross-mode hits."""
    h = hashlib.sha256()
    h.update(canonical_sample_bytes(sample))
    h.update(b"\x00model:")
    h.update(model.encode())
    h.update(b"\x00quant:1" if quantized else b"\x00quant:0")
    return h.hexdigest()


class AnswerCache:
    """Byte-budgeted LRU of per-request head answers, keyed by
    :func:`answer_key`. Thread-safe; array copies happen OUTSIDE the lock
    (the lock serializes bookkeeping only, so dispatcher threads don't
    stall each other on memcpy)."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, tuple[list[np.ndarray], int]]" = (  # guarded-by: _lock
            OrderedDict()
        )
        self.bytes = 0  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.insertions = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.oversize_skips = 0  # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @staticmethod
    def _cost(key: str, heads: list[np.ndarray]) -> int:
        return sum(int(a.nbytes) for a in heads) + len(key)

    def get(self, key: str) -> "list[np.ndarray] | None":
        """The cached heads (fresh writable copies) or None. A hit
        promotes the entry to the hot end."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            heads = entry[0]  # reference only under the lock
        return [np.array(a) for a in heads]

    def put(self, key: str, heads: "list[np.ndarray]") -> bool:
        """Insert (a pristine copy of) one answer; False when the cache is
        disabled (budget 0) or the single answer exceeds the whole budget
        (caching it would just evict everything else for one entry)."""
        if self.budget_bytes <= 0:
            return False
        copies = [np.array(a) for a in heads]
        cost = self._cost(key, copies)
        if cost > self.budget_bytes:
            with self._lock:
                self.oversize_skips += 1
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old[1]
            self._entries[key] = (copies, cost)
            self.bytes += cost
            self.insertions += 1
            while self.bytes > self.budget_bytes and self._entries:
                _, (_, evicted_cost) = self._entries.popitem(last=False)
                self.bytes -= evicted_cost
                self.evictions += 1
        return True

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            out = {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "budget_bytes": self.budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else None,
                "insertions": self.insertions,
                "evictions": self.evictions,
                "oversize_skips": self.oversize_skips,
            }
        # the registry's gauges, outside the lock (the telemetry locks are
        # not nested under ours)
        from ... import telemetry as tel

        tel.publish("fleet_cache", out)
        return out


__all__ = ["AnswerCache", "answer_key", "canonical_sample_bytes"]
