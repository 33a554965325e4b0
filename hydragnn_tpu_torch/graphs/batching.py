"""Collating and padding graph samples into static-shape ``GraphBatch``es.

Counterpart of ``hydragnn_tpu/graphs/batching.py``: the same pad buckets,
the same padding convention, the same array contents (the CPU tests hold
every field ``np.array_equal`` to the JAX package's collate). Arrays are
built in numpy on the host and wrapped as CPU tensors; ``GraphBatch.to``
moves them to the card.

Padding convention:
* padded node slots: features zero, assigned to the dummy padding graph
  (graph id ``n_graph - 1``), ``node_mask = 0``;
* padded edge slots: ``senders = receivers = n_node - 1`` (a padded node),
  ``edge_mask = 0``;
* one extra graph slot is always reserved for the padding graph, so a bucket
  declared for ``B`` real graphs has ``n_graph = B + 1``.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Iterable, Sequence

import numpy as np
import torch

from .graph import BatchMeta, GraphBatch, GraphSample


def _round_up(value: int, multiple: int) -> int:
    return int(math.ceil(max(value, 1) / multiple) * multiple)


class PadSpec:
    """A static padding bucket: (n_node, n_edge, n_graph[, n_triplet]) with
    n_graph including the trailing dummy padding graph. ``node_cap`` is the
    dataset-wide per-graph node bound (0 = unknown). ``attn_cap`` is GPS's
    dense-attention width (``max_graph_nodes``) when the user set it below
    the dataset max (0 = not capped): collate then certifies fitting batches
    at the cap, so they keep the dense-block path."""

    __slots__ = ("n_node", "n_edge", "n_graph", "n_triplet", "node_cap", "attn_cap")

    def __init__(self, n_node: int, n_edge: int, n_graph: int, n_triplet: int = 0,
                 node_cap: int = 0, attn_cap: int = 0):
        self.n_node = int(n_node)
        self.n_edge = int(n_edge)
        self.n_graph = int(n_graph)
        self.n_triplet = int(n_triplet)
        self.node_cap = int(node_cap)
        self.attn_cap = int(attn_cap)

    def as_tuple(self) -> tuple[int, int, int, int]:
        return (self.n_node, self.n_edge, self.n_graph, self.n_triplet)

    def __eq__(self, other) -> bool:
        return isinstance(other, PadSpec) and self.as_tuple() == other.as_tuple()

    def __hash__(self) -> int:
        return hash(self.as_tuple())

    def __repr__(self) -> str:
        return (
            f"PadSpec(n_node={self.n_node}, n_edge={self.n_edge}, "
            f"n_graph={self.n_graph}, n_triplet={self.n_triplet})"
        )


def compute_pad_spec(samples: Sequence[GraphSample], batch_size: int, node_multiple: int = 8,
                     edge_multiple: int = 128, slack: float = 1.0,
                     attn_cap: int = 0) -> PadSpec:
    """A bucket that fits any ``batch_size`` samples drawn from ``samples``:
    max-per-sample × batch_size, rounded up to the given multiples."""
    max_nodes = max((s.num_nodes for s in samples), default=1)
    max_edges = max((s.num_edges for s in samples), default=1)
    n_node = _round_up(int(max_nodes * batch_size * slack) + 1, node_multiple)
    n_edge = _round_up(int(max_edges * batch_size * slack) + 1, edge_multiple)
    max_triplets = max(
        (s.extras["idx_kj"].shape[0] for s in samples if "idx_kj" in s.extras), default=0,
    )
    n_triplet = (
        _round_up(int(max_triplets * batch_size * slack), edge_multiple) if max_triplets else 0
    )
    return PadSpec(
        n_node=n_node, n_edge=n_edge, n_graph=batch_size + 1, n_triplet=n_triplet,
        node_cap=int(max_nodes), attn_cap=int(attn_cap),
    )


def collate_numpy(samples: Sequence[GraphSample], pad: PadSpec) -> dict[str, np.ndarray]:
    """Concatenate ``samples`` and pad to ``pad``, as a dict of numpy arrays
    keyed by ``GraphBatch`` field. Raises if the bucket is too small."""
    n_graphs = len(samples)
    if n_graphs > pad.n_graph - 1:
        raise ValueError(f"{n_graphs} graphs exceed bucket capacity {pad.n_graph - 1}")
    tot_nodes = sum(s.num_nodes for s in samples)
    tot_edges = sum(s.num_edges for s in samples)
    # strictly fewer real nodes than slots: pad edges are wired to node
    # n_node-1, which must itself be a padding node
    if tot_nodes >= pad.n_node or tot_edges > pad.n_edge:
        raise ValueError(
            f"batch ({tot_nodes} nodes, {tot_edges} edges) exceeds bucket {pad!r} "
            f"(need tot_nodes < n_node to reserve a padding node)"
        )

    first = samples[0]
    fx = first.x.shape[1]
    fe = first.edge_attr.shape[1]
    fg = first.graph_attr.shape[0]
    yg = first.graph_y.shape[0]
    yn = first.node_y.shape[1]

    N, E, G = pad.n_node, pad.n_edge, pad.n_graph
    a = {
        "x": np.zeros((N, fx), np.float32),
        "pos": np.zeros((N, 3), np.float32),
        "senders": np.full((E,), N - 1, np.int32),
        "receivers": np.full((E,), N - 1, np.int32),
        "edge_attr": np.zeros((E, fe), np.float32),
        "edge_shifts": np.zeros((E, 3), np.float32),
        "batch": np.full((N,), G - 1, np.int32),
        "graph_attr": np.zeros((G, fg), np.float32),
        "graph_y": np.zeros((G, yg), np.float32),
        "node_y": np.zeros((N, yn), np.float32),
        "energy_y": np.zeros((G, 1), np.float32),
        "forces_y": np.zeros((N, 3), np.float32),
        "node_mask": np.zeros((N,), np.float32),
        "edge_mask": np.zeros((E,), np.float32),
        "graph_mask": np.zeros((G,), np.float32),
        "n_node": np.zeros((G,), np.int32),
        "dataset_id": np.zeros((G,), np.int32),
    }
    T = pad.n_triplet
    # padded triplets point at the last (padded) edge slot
    a["idx_kj"] = np.full((T,), E - 1, np.int32)
    a["idx_ji"] = np.full((T,), E - 1, np.int32)
    a["triplet_mask"] = np.zeros((T,), np.float32)
    tot_triplets = sum(s.extras.get("idx_kj", np.zeros(0)).shape[0] for s in samples)
    if tot_triplets > T:
        raise ValueError(f"batch has {tot_triplets} triplets, bucket holds {T}")
    pe_dim = first.extras["pe"].shape[1] if "pe" in first.extras else 0
    a["pe"] = np.zeros((N, pe_dim), np.float32)
    a["rel_pe"] = np.zeros((E, pe_dim), np.float32)
    a["z"] = np.zeros((N,), np.int32)

    node_off = edge_off = trip_off = 0
    for g, s in enumerate(samples):
        n, e = s.num_nodes, s.num_edges
        ns, es = slice(node_off, node_off + n), slice(edge_off, edge_off + e)
        a["x"][ns] = s.x
        a["pos"][ns] = s.pos
        a["senders"][es] = s.senders + node_off
        a["receivers"][es] = s.receivers + node_off
        if fe:
            a["edge_attr"][es] = s.edge_attr
        a["edge_shifts"][es] = s.edge_shifts
        a["batch"][ns] = g
        if fg:
            a["graph_attr"][g] = s.graph_attr
        if yg:
            a["graph_y"][g] = s.graph_y
        if yn:
            a["node_y"][ns] = s.node_y
        a["energy_y"][g] = s.energy_y
        a["forces_y"][ns] = s.forces_y
        a["node_mask"][ns] = 1.0
        a["edge_mask"][es] = 1.0
        a["graph_mask"][g] = 1.0
        a["n_node"][g] = n
        a["dataset_id"][g] = s.dataset_id
        zs = s.extras.get("atomic_numbers", s.x[:, 0] if s.x.shape[1] else np.zeros(n))
        a["z"][ns] = np.round(np.asarray(zs).reshape(-1)).astype(np.int32)
        if pe_dim and "pe" in s.extras:
            a["pe"][ns] = s.extras["pe"]
            a["rel_pe"][es] = s.extras["rel_pe"]
        if T and "idx_kj" in s.extras:
            t = s.extras["idx_kj"].shape[0]
            a["idx_kj"][trip_off : trip_off + t] = s.extras["idx_kj"] + edge_off
            a["idx_ji"][trip_off : trip_off + t] = s.extras["idx_ji"] + edge_off
            a["triplet_mask"][trip_off : trip_off + t] = 1.0
            trip_off += t
        node_off += n
        edge_off += e
    return a


def is_sorted(ids: np.ndarray) -> bool:
    """Whether ``ids`` are non-decreasing (a ``BatchMeta`` certificate)."""
    return bool(ids.size < 2 or np.all(ids[1:] >= ids[:-1]))


def batch_meta(arrays: dict[str, np.ndarray], node_cap: int = 0,
               attn_cap: int = 0) -> BatchMeta:
    """Certify a collated batch host-side: which id arrays are sorted (the
    CSR kernels then need no sort) and the per-graph node bound — the
    user's dense-attention cap ``attn_cap`` when it is below ``node_cap``
    and the batch honours it, else the dataset-wide ``node_cap`` when the
    batch honours that, else a power of two."""
    n_node = arrays["n_node"]
    largest = int(n_node.max()) if n_node.size else 0
    pow2 = max(1 << max(largest - 1, 0).bit_length(), 8)
    if attn_cap and 0 < attn_cap < node_cap:
        bound = attn_cap if largest <= attn_cap else pow2
    elif node_cap and largest <= node_cap:
        bound = node_cap
    else:
        bound = pow2
    return BatchMeta(
        max_n_node=bound,
        recv_sorted=is_sorted(arrays["receivers"]),
        send_sorted=is_sorted(arrays["senders"]),
        batch_sorted=is_sorted(arrays["batch"]),
        ji_sorted=is_sorted(arrays["idx_ji"]),
    )


def batch_from_arrays(arrays: dict[str, np.ndarray], meta: BatchMeta | None) -> GraphBatch:
    """Wrap collated numpy arrays (no copy) as a CPU ``GraphBatch``."""
    return GraphBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}, meta=meta)


def collate(samples: Sequence[GraphSample], pad: PadSpec) -> GraphBatch:
    """Concatenate ``samples`` and pad to ``pad`` as a CPU ``GraphBatch``
    with its certified ``BatchMeta``. Raises if the bucket is too small —
    padding is sized by ``compute_pad_spec`` or a bucket table, never
    silently truncated."""
    arrays = collate_numpy(samples, pad)
    return batch_from_arrays(arrays, batch_meta(arrays, pad.node_cap, pad.attn_cap))


def compute_pad_buckets(
    samples: Sequence[GraphSample],
    batch_size: int,
    max_buckets: int = 4,
    node_multiple: int = 8,
    edge_multiple: int = 128,
    quantiles: Sequence[float] = (0.5, 0.8, 0.95),
    n_sim: int = 512,
    seed: int = 0,
    attn_cap: int = 0,
) -> list[PadSpec]:
    """Up to ``max_buckets`` buckets at quantile levels of simulated random
    batch totals; the top bucket is ``compute_pad_spec``'s worst case, so
    any batch fits."""
    worst = compute_pad_spec(samples, batch_size, node_multiple, edge_multiple,
                             attn_cap=attn_cap)
    if len(samples) <= batch_size or max_buckets <= 1:
        return [worst]
    sizes = np.array(
        [
            (s.num_nodes, s.num_edges,
             s.extras["idx_kj"].shape[0] if "idx_kj" in s.extras else 0)
            for s in samples
        ],
        np.int64,
    )
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, len(samples), size=(n_sim, batch_size))
    totals = sizes[draws].sum(axis=1)  # [n_sim, 3]
    buckets: list[PadSpec] = []
    for q in list(quantiles)[: max_buckets - 1]:
        n, e, t = np.quantile(totals, q, axis=0)
        spec = PadSpec(
            n_node=min(_round_up(int(n) + 1, node_multiple), worst.n_node),
            n_edge=min(_round_up(int(e), edge_multiple), worst.n_edge),
            n_graph=batch_size + 1,
            n_triplet=min(_round_up(int(t), edge_multiple), worst.n_triplet)
            if worst.n_triplet else 0,
            node_cap=worst.node_cap,
            attn_cap=worst.attn_cap,
        )
        if spec not in buckets and spec != worst:
            buckets.append(spec)
    buckets.append(worst)
    return buckets


def pick_bucket(buckets: Sequence[PadSpec], tot_node: int, tot_edge: int,
                tot_triplet: int = 0, n_graphs: int = 0) -> PadSpec | None:
    """Smallest bucket of an ascending table that fits the batch totals
    (strictly fewer nodes than slots), or ``None`` if none does."""
    for b in buckets:
        if (
            tot_node < b.n_node
            and tot_edge <= b.n_edge
            and tot_triplet <= b.n_triplet
            and n_graphs <= b.n_graph - 1
        ):
            return b
    return None


class GraphLoader:
    """Host-side loader: shuffles, batches, collates each batch to the
    smallest bucket that fits (one process; the JAX package's per-rank
    slicing comes with the parallelism slice). With :meth:`set_superstep`
    the epoch is planned bucket-major, as the JAX loader plans it."""

    def __init__(self, samples: Sequence[GraphSample], batch_size: int,
                 pad: PadSpec | None = None, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, buckets: int | Sequence[PadSpec] | None = None):
        self.samples = list(samples)
        if not self.samples and pad is None:
            raise ValueError("empty dataset needs an explicit pad spec")
        self.batch_size = int(batch_size)
        if isinstance(buckets, int):
            self.buckets = compute_pad_buckets(self.samples, self.batch_size,
                                               max_buckets=buckets)
        elif buckets:
            self.buckets = sorted(buckets, key=lambda p: p.as_tuple())
        else:
            self.buckets = None
        if self.buckets:
            self.pad = self.buckets[-1]
        else:
            self.pad = pad or compute_pad_spec(self.samples, self.batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.block = 1

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def set_superstep(self, k: int) -> None:
        """Superstep blocks (``train/superstep.py``): runs of ``k``
        consecutive batches of one bucket. :meth:`batch_plan` then orders
        the epoch bucket-major: each bucket's batches in runs of ``k``, and
        the leftover batches (fewer than ``k`` in a bucket) re-collated to
        the component-wise max of the bucket table and put at the epoch's
        tail, so no sample is dropped and every block's shape comes from the
        table. The plan is the JAX loader's (``set_superstep`` with one
        device), index for index."""
        self.block = max(1, int(k))

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.samples)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return int(math.ceil(n / self.batch_size))

    def _pick(self, chunk) -> PadSpec:
        if not self.buckets:
            return self.pad
        chosen = [self.samples[i] for i in chunk]
        return pick_bucket(
            self.buckets,
            sum(s.num_nodes for s in chosen),
            sum(s.num_edges for s in chosen),
            sum(s.extras["idx_kj"].shape[0] for s in chosen if "idx_kj" in s.extras),
        ) or self.buckets[-1]

    def _max_spec(self, members: Sequence[PadSpec]) -> PadSpec:
        """Component-wise max over ``members`` (a table bucket when one
        equals it)."""
        pad = PadSpec(
            n_node=max(m.n_node for m in members),
            n_edge=max(m.n_edge for m in members),
            n_graph=max(m.n_graph for m in members),
            n_triplet=max(m.n_triplet for m in members),
            node_cap=members[0].node_cap,
            attn_cap=members[0].attn_cap,
        )
        return next((b for b in self.buckets or () if b == pad), pad)

    def batch_plan(self) -> list[tuple[np.ndarray, PadSpec]]:
        """This epoch's (sample indices, bucket) per batch, bucket-major
        under :meth:`set_superstep`."""
        idx = self._epoch_indices()
        plan = []
        for b in range(len(self)):
            chunk = idx[b * self.batch_size : (b + 1) * self.batch_size]
            if len(chunk) == 0:
                break
            plan.append((chunk, self._pick(chunk)))
        if self.block > 1 and self.buckets and len(plan) > 1:
            plan = self._bucket_major(plan)
        return plan

    def _bucket_major(self, plan):
        """Each bucket's batches in runs of ``block`` (buckets in order of
        first appearance), then the leftovers at the table's max bucket
        (constant per loader, so the tail's shape never depends on the
        epoch's mix)."""
        by_bucket: dict = {}
        for item in plan:
            by_bucket.setdefault(item[1].as_tuple(), []).append(item)
        ordered, leftover = [], []
        for items in by_bucket.values():
            full = len(items) // self.block * self.block
            ordered.extend(items[:full])
            leftover.extend(items[full:])
        if leftover:
            top = self._max_spec(self.buckets)
            ordered.extend((chunk, top) for chunk, _ in leftover)
        return ordered

    def collate_chunk(self, chunk: np.ndarray, pad: PadSpec) -> GraphBatch:
        return collate([self.samples[i] for i in chunk], pad)

    def __iter__(self) -> Iterable[GraphBatch]:
        for chunk, pad in self.batch_plan():
            yield self.collate_chunk(chunk, pad)


def background_iter(iterable, depth: int = 2):
    """Consume ``iterable`` in a daemon worker thread, up to ``depth``
    finished items ahead of the consumer (:class:`PrefetchLoader`'s
    collate and host-to-device copy; the port's counterpart of the JAX
    package's ``double_buffer`` too, since a block is its batches).
    Exceptions of the worker re-raise in the consumer; a consumer that stops
    early stops the worker at its next put."""
    q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    return
            put(done)
        except BaseException as exc:  # re-raised in the consumer
            put(exc)

    thread = threading.Thread(target=worker, daemon=True, name="background_iter")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)


class PrefetchLoader:
    """Runs a loader's collate (and, with ``device``, the host-to-device
    copy) in one background thread, ``depth`` batches ahead of the consumer
    (at least one superstep block and one batch more under
    :meth:`set_superstep`), as the JAX package's single-process
    ``PrefetchLoader`` does."""

    def __init__(self, loader, depth: int = 2, device=None):
        self.loader = loader
        self.depth = max(1, int(depth))
        self.device = device
        self.samples = loader.samples
        self.pad = loader.pad
        self.superstep = 1

    @property
    def seed(self):
        return self.loader.seed

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def set_superstep(self, k: int) -> None:
        """The wrapped loader's bucket-major plan, and a buffer that holds
        the next block while the current one runs."""
        self.superstep = max(1, int(k))
        self.loader.set_superstep(k)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        depth = max(self.depth, self.superstep + 1) if self.superstep > 1 else self.depth
        moved = (b if self.device is None else b.to(self.device) for b in self.loader)
        return background_iter(moved, depth=depth)


__all__ = [
    "GraphLoader",
    "PadSpec",
    "PrefetchLoader",
    "background_iter",
    "batch_from_arrays",
    "batch_meta",
    "collate",
    "collate_numpy",
    "compute_pad_buckets",
    "compute_pad_spec",
    "is_sorted",
    "pick_bucket",
]
