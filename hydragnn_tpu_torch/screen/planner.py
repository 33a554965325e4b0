"""Bucket-major screening planner: a block layout of a whole sample store
from graph sizes alone.

Counterpart of ``hydragnn_tpu/screen/planner.py`` (the same packing, the
same blocks, the same fingerprint for the same inputs). The planner reads
graph SIZES only, never content: against a store with ``sample_sizes``
(``datasets.packed``, ``datasets.sharded``) planning costs no sample fetch,
and content moves once, when the executor fetches a planned block.

Packing: each graph goes to the tightest bucket of the table that admits it
alone, appended to that bucket's open block until the block cannot take
the next graph, so every non-tail block is FULL for its bucket; every block
shape is drawn from the warmed bucket table, so the executor replays the
CUDA graphs its warm-up captured and captures nothing more. Graphs left in
partial blocks at the stream's end re-pad to the TOP bucket (the worst-case
bound admits any mix) and pack the plan's tail: no graph is dropped.

The plan is a pure function of (indices, sizes, bucket table, order flag):
re-planned after an interruption it yields the identical block sequence,
which makes the engine's sidecar resume exact (skip ``blocks_done`` blocks,
score the rest: none lost, none scored twice).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Sequence

import numpy as np

from ..graphs.batching import PadSpec, pick_bucket

PLAN_VERSION = 1


class ScreenBlock(NamedTuple):
    indices: np.ndarray  # global sample indices, stream order within block
    pad: PadSpec


class ScreenPlan(NamedTuple):
    blocks: list  # list[ScreenBlock]
    buckets: list  # the ascending bucket table the blocks draw from
    fingerprint: str  # identity for exact resume (sidecar match)
    n_graphs: int
    n_tail_blocks: int  # trailing partial blocks re-padded to the top bucket


def _sizes_for(store, indices: np.ndarray) -> np.ndarray:
    """[k, 3] (nodes, edges, triplets) per graph, content-free when the
    store answers from a count index (``sample_sizes``, triplets 0 — the
    same convention ``GraphLoader._pick_bucket_indices`` uses)."""
    if hasattr(store, "sample_sizes"):
        sz = np.asarray(store.sample_sizes(indices), np.int64)
        return np.concatenate([sz, np.zeros((len(sz), 1), np.int64)], axis=1)
    out = np.zeros((len(indices), 3), np.int64)
    for row, i in enumerate(indices):
        s = store[int(i)]
        t = s.extras["idx_kj"].shape[0] if "idx_kj" in s.extras else 0
        out[row] = (s.num_nodes, s.num_edges, t)
    return out


def plan_fingerprint(
    indices: np.ndarray, buckets: Sequence[PadSpec], bucket_major: bool
) -> str:
    """Identity of a plan: same inputs => same fingerprint => same blocks.
    A resume refuses to proceed when the sidecar's fingerprint differs —
    skipping ``blocks_done`` blocks of a DIFFERENT plan would silently
    lose / double-score graphs."""
    h = hashlib.sha256()
    h.update(f"v{PLAN_VERSION};major={int(bool(bucket_major))};".encode())
    for b in buckets:
        h.update(f"{b.as_tuple()}:{b.node_cap}:{b.attn_cap};".encode())
    h.update(np.ascontiguousarray(np.asarray(indices, np.int64)).tobytes())
    return h.hexdigest()[:32]


def plan_screen(
    store,
    indices,
    buckets: Sequence[PadSpec],
    bucket_major: bool = True,
) -> ScreenPlan:
    """Lay ``indices`` (stream order) out as full-bucket blocks.

    ``store``: anything indexable by the given indices; stores exposing
    ``sample_sizes`` (PackedDataset / ShardedStore) are planned without
    touching sample content. ``buckets``: the ascending PadSpec table the
    executor warmed (top = worst case). ``bucket_major=False`` keeps blocks
    in close order (stream-ish) instead of grouping by bucket — same
    blocks, same scores, more executable switching."""
    indices = np.asarray(list(map(int, indices)), np.int64)
    buckets = sorted(buckets, key=lambda p: p.as_tuple())
    top = buckets[-1]
    sizes = _sizes_for(store, indices)

    def fits(b: PadSpec, tn: int, te: int, tt: int, ng: int) -> bool:
        # same admission rule as pick_bucket: collate reserves the last
        # node slot (padding sink) and the last graph slot
        return (
            tn < b.n_node and te <= b.n_edge and tt <= b.n_triplet
            and ng <= b.n_graph - 1
        )

    open_blocks: dict = {}  # bucket tuple -> [idx list, tn, te, tt]
    closed: dict = {b.as_tuple(): [] for b in buckets}
    close_order: list = []  # (bucket tuple, idx list) in close order
    for row, i in enumerate(indices):
        n, e, t = (int(x) for x in sizes[row])
        home = pick_bucket(buckets, n, e, t, 1) or top
        key = home.as_tuple()
        ob = open_blocks.get(key)
        if ob is not None and fits(home, ob[1] + n, ob[2] + e, ob[3] + t,
                                   len(ob[0]) + 1):
            ob[0].append(int(i))
            ob[1] += n
            ob[2] += e
            ob[3] += t
        else:
            if ob is not None:  # full for its bucket: close it
                closed[key].append(ob[0])
                close_order.append((key, ob[0]))
            open_blocks[key] = [[int(i)], n, e, t]

    # stream-order merge of the partial leftovers, re-packed to the TOP
    # bucket (admits any mix by construction) at the plan tail
    pos = {int(i): r for r, i in enumerate(indices)}
    leftover: list = []
    for ob in open_blocks.values():
        leftover.extend(ob[0])
    leftover.sort(key=pos.__getitem__)
    tail: list = []
    cur: list = [[], 0, 0, 0]
    for i in leftover:
        n, e, t = (int(x) for x in sizes[pos[i]])
        if cur[0] and not fits(top, cur[1] + n, cur[2] + e, cur[3] + t,
                               len(cur[0]) + 1):
            tail.append(cur[0])
            cur = [[], 0, 0, 0]
        cur[0].append(i)
        cur[1] += n
        cur[2] += e
        cur[3] += t
    if cur[0]:
        tail.append(cur[0])

    by_tuple = {b.as_tuple(): b for b in buckets}
    blocks: list = []
    if bucket_major:
        for b in buckets:
            blocks.extend(
                ScreenBlock(np.asarray(idx, np.int64), b)
                for idx in closed[b.as_tuple()]
            )
    else:
        blocks.extend(
            ScreenBlock(np.asarray(idx, np.int64), by_tuple[key])
            for key, idx in close_order
        )
    blocks.extend(ScreenBlock(np.asarray(idx, np.int64), top) for idx in tail)

    return ScreenPlan(
        blocks=blocks,
        buckets=list(buckets),
        fingerprint=plan_fingerprint(indices, buckets, bucket_major),
        n_graphs=int(len(indices)),
        n_tail_blocks=len(tail),
    )


__all__ = ["ScreenBlock", "ScreenPlan", "plan_fingerprint", "plan_screen"]
