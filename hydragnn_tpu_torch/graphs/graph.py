"""Padded graph batches as tensors, and the host-side graph sample.

Counterpart of ``hydragnn_tpu/graphs/graph.py``. The padding convention is
the JAX package's, unchanged: every batch is padded to a static
``(n_node, n_edge, n_graph)`` bucket; padded nodes and edges belong to the
trailing dummy graph; pad edges are wired to node ``N - 1`` with
``edge_mask = 0``; targets are columnar (one column slice per head).

What differs is ``BatchMeta``: the JAX certificates are a TPU VMEM window
contract that means nothing to the port's CSR kernels. Here collate
certifies which id arrays are globally sorted, so the kernels' row pointers
need no sort, and keeps the per-graph node bound.

The CSR views cover the node-row ids (``receivers``, ``senders``), the
graph-row ids (``batch``), GAT's self-loop layout and, for DimeNet's
triplet sum, the edge-row ids ``idx_ji`` (sorted by construction, and
certified so) and ``idx_kj`` (its transpose, argsorted).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.fused_scatter import SegmentIndex, gather_rows, segment_index
from ..ops.fused_softmax import self_loop_pad


@dataclasses.dataclass(frozen=True)
class BatchMeta:
    """Host-certified layout facts of one collated batch. ``None`` means
    unknown (a hand-built batch): consumers then assume nothing.

    - ``max_n_node``: upper bound on the node count of any one graph;
    - ``recv_sorted`` / ``send_sorted`` / ``batch_sorted`` /
      ``ji_sorted``: whether ``receivers`` / ``senders`` / ``batch`` /
      ``idx_ji`` are non-decreasing."""

    max_n_node: int | None = None
    recv_sorted: bool | None = None
    send_sorted: bool | None = None
    batch_sorted: bool | None = None
    ji_sorted: bool | None = None


# Batch fields in the JAX ``GraphBatch`` order (``meta`` excluded).
FIELDS = (
    "x", "pos", "senders", "receivers", "edge_attr", "edge_shifts", "batch",
    "graph_attr", "graph_y", "node_y", "energy_y", "forces_y", "node_mask",
    "edge_mask", "graph_mask", "n_node", "dataset_id", "idx_kj", "idx_ji",
    "triplet_mask", "pe", "rel_pe", "z",
)

# rows of MACE's element table: atomic numbers 0..118 (``z`` clipped)
NUM_ELEMENTS = 119

# which BatchMeta flag certifies which id array (``idx_kj`` is never sorted)
_SORTED_FLAG = {"receivers": "recv_sorted", "senders": "send_sorted", "batch": "batch_sorted",
                "idx_ji": "ji_sorted", "idx_kj": None}
# the CSR views of GAT's extended layout: which of self_loop_edges()
_LOOP_FIELD = {"loop_senders": 0, "loop_receivers": 1}


def loop_tail(num_edges: int, num_nodes: int, world: int = 1,
              rank: int = 0) -> tuple[int, int, int]:
    """GAT's extended layout after the edges: ``self_loop_pad`` masked slots
    and ``num_nodes`` self loops, the tail, of ``T`` rows. Under edge
    sharding (``world`` ranks of ``num_edges`` edges each: the whole batch
    has ``world * num_edges``), the tail is cut into ``world`` blocks of
    ``ceil(T / world)`` rows, the last padded with masked slots; returns
    ``(slots, start, rows)``: the tail's alignment slots, this rank's first
    tail row and its block's row count. One rank: ``(slots, 0, T)``."""
    slots = self_loop_pad(num_edges * world)
    rows = -(-(slots + num_nodes) // world)
    return slots, rank * rows, rows


def edge_space_rows(num_edges: int, num_nodes: int, num_triplets: int = 0, world: int = 1,
                    rank: int = 0) -> frozenset:
    """The leading sizes of a rank's edge-space tensors under edge sharding
    (``world`` ranks of ``num_edges`` edges each): its edges, GAT's
    extended layout over them (the edges and this rank's tail block,
    :func:`loop_tail`) and, where there are any, its ``num_triplets``
    triplets (DimeNet's)."""
    rows = {num_edges, num_edges + loop_tail(num_edges, num_nodes, world, rank)[2]}
    if num_triplets:
        rows.add(num_triplets)
    return frozenset(rows)


def loop_tail_nodes(num_edges: int, num_nodes: int, world: int = 1, rank: int = 0,
                    device=None) -> torch.Tensor:
    """The node of each row of this rank's tail block (:func:`loop_tail`):
    ``N - 1`` for an alignment or padding slot, ``v`` for node ``v``'s self
    loop (int64)."""
    slots, start, rows = loop_tail(num_edges, num_nodes, world, rank)
    t = torch.arange(start, start + rows, device=device)
    loop = (t >= slots) & (t < slots + num_nodes)
    return torch.where(loop, t - slots, torch.full_like(t, num_nodes - 1))


def loop_tail_mask(num_edges: int, num_nodes: int, world: int = 1, rank: int = 0,
                   device=None) -> torch.Tensor:
    """1.0 for this rank's tail rows that are self loops, 0.0 for its slots
    (float32)."""
    slots, start, rows = loop_tail(num_edges, num_nodes, world, rank)
    t = torch.arange(start, start + rows, device=device)
    return ((t >= slots) & (t < slots + num_nodes)).to(torch.float32)


@dataclasses.dataclass
class GraphBatch:
    """A batch of graphs padded to static shapes (tensors; shapes as in the
    JAX ``GraphBatch``: N padded nodes, E padded edges, G graph slots with
    the trailing dummy graph)."""

    x: torch.Tensor
    pos: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    edge_attr: torch.Tensor
    edge_shifts: torch.Tensor
    batch: torch.Tensor
    graph_attr: torch.Tensor
    graph_y: torch.Tensor
    node_y: torch.Tensor
    energy_y: torch.Tensor
    forces_y: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    graph_mask: torch.Tensor
    n_node: torch.Tensor
    dataset_id: torch.Tensor
    idx_kj: torch.Tensor
    idx_ji: torch.Tensor
    triplet_mask: torch.Tensor
    pe: torch.Tensor
    rel_pe: torch.Tensor
    z: torch.Tensor
    meta: BatchMeta | None = None
    # CSR views of the id arrays and GAT's self-loop edge layout, built once
    # per batch on first use
    _csr: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                   compare=False)

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def replace(self, **kwargs) -> "GraphBatch":
        """A copy with some fields replaced (the CSR cache starts empty)."""
        return dataclasses.replace(self, **kwargs)

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        """Every tensor field moved to ``device``."""
        return self.replace(**{
            f: getattr(self, f).to(device, non_blocking=non_blocking) for f in FIELDS
        })

    def map_floats(self, fn) -> "GraphBatch":
        """A copy with ``fn`` applied to every floating-point field. The id
        arrays are shared, and so is their CSR cache."""
        out = self.replace(**{
            f: (fn(t) if t.is_floating_point() else t)
            for f in FIELDS for t in (getattr(self, f),)
        })
        out._csr = self._csr
        return out

    def with_edge_attr(self, edge_attr: torch.Tensor) -> "GraphBatch":
        """A copy carrying ``edge_attr`` (GPS's edge encodings for its local
        conv); the id arrays are shared, and so is their CSR cache."""
        out = self.replace(edge_attr=edge_attr)
        out._csr = self._csr
        return out

    def edge_vectors(self, recv_index: SegmentIndex | None = None,
                     send_index: SegmentIndex | None = None) -> torch.Tensor:
        """``[E, 3]`` sender-to-receiver position vectors plus the periodic
        shifts, ``pos[receivers] - pos[senders] + edge_shifts``. The gathers
        are :func:`gather_rows`, whose backward (forces) is the segment-sum
        kernel over the receivers' and senders' CSR views (built when needed
        and not given)."""
        return (gather_rows(self.pos, self.receivers, recv_index)
                - gather_rows(self.pos, self.senders, send_index) + self.edge_shifts)

    def edge_lengths(self, eps: float = 1e-12) -> torch.Tensor:
        """``[E, 1]`` edge lengths, ``sqrt(|vec|^2 + eps)``: the ``eps`` keeps
        the gradient of a pad edge's zero vector finite."""
        vec = self.edge_vectors()
        return torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True) + eps)

    def self_loop_edges(self, shard: tuple[int, int] | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """GAT's extended edge layout, cached: ``(senders, receivers)`` of the
        real edges, then ``self_loop_pad(E)`` masked slots wired to the dummy
        node N-1, then one self loop per node (``arange(N)``), as the JAX
        GAT builds it (its mask is 1, 0, 1 over the three sections).

        ``shard = (world, rank)`` (the edge-sharded route; this batch holds
        rank ``rank``'s block of ``world`` equal edge blocks): this rank's
        share of the whole batch's layout, its own edges followed by its
        block of the tail (:func:`loop_tail`), whose rows past the tail are
        masked slots on N-1. One rank's share is the layout above."""
        world, rank = shard if shard is not None else (1, 0)
        key = "self_loop_edges" if world == 1 else f"self_loop_edges@{world}.{rank}"
        loops = self._csr.get(key)
        if loops is None:
            # cached for later steps, which may take gradients: built as
            # ordinary tensors even under an inference-mode forward
            with torch.inference_mode(False):
                nodes = loop_tail_nodes(self.num_edges, self.num_nodes, world, rank,
                                        device=self.senders.device).to(self.senders.dtype)
                loops = (torch.cat([self.senders, nodes]), torch.cat([self.receivers, nodes]))
            self._csr[key] = loops
        return loops

    def csr(self, field: str, shard: tuple[int, int] | None = None) -> SegmentIndex:
        """Cached row pointer (and sort permutation, unless collate
        certified the ids sorted) of ``receivers`` (N rows), ``senders``
        (N rows), ``batch`` (G rows), ``idx_ji`` / ``idx_kj`` (E rows:
        DimeNet's triplets, by the edge they feed and the edge they read),
        ``elements`` (``z`` clipped to ``[0, NUM_ELEMENTS)``, NUM_ELEMENTS
        rows: MACE's element embedding), or ``loop_receivers`` /
        ``loop_senders``, the ids of :meth:`self_loop_edges` (N rows, always
        argsorted: the self-loop section follows the real edges), for the
        CSR kernels. ``shard = (world, rank)`` (the edge-sharded route, world
        above 1): the loop fields of this rank's share of the layout, and
        ``idx_kj`` over the rows of every rank's edges (DimeNet's triplets
        read them all)."""
        sharded = shard is not None and shard[0] > 1 and field in ("idx_kj", *_LOOP_FIELD)
        key = f"{field}@{shard[0]}.{shard[1]}" if sharded else field
        idx = self._csr.get(key)
        if idx is None and sharded:
            with torch.inference_mode(False):
                if field in _LOOP_FIELD:
                    idx = segment_index(self.self_loop_edges(shard)[_LOOP_FIELD[field]],
                                        self.num_nodes)
                else:
                    idx = segment_index(self.idx_kj, self.num_edges * shard[0])
            self._csr[key] = idx
        elif idx is None:
            if field in _LOOP_FIELD:
                idx = segment_index(self.self_loop_edges()[_LOOP_FIELD[field]], self.num_nodes)
            elif field == "elements":
                idx = segment_index(torch.clamp(self.z.to(torch.int32), 0, NUM_ELEMENTS - 1),
                                    NUM_ELEMENTS)
            else:
                flag = _SORTED_FLAG[field]
                is_sorted = (getattr(self.meta, flag)
                             if self.meta is not None and flag is not None else None)
                rows = {"batch": self.num_graphs, "idx_ji": self.num_edges,
                        "idx_kj": self.num_edges}.get(field, self.num_nodes)
                idx = segment_index(getattr(self, field), rows, is_sorted=is_sorted)
            self._csr[field] = idx
        return idx

    def views(self, forward: tuple[str, ...], backward: tuple[str, ...] = (),
              shard: tuple[int, int] | None = None) -> tuple[SegmentIndex | None, ...]:
        """The :meth:`csr` views of ``forward`` and then ``backward``, in
        that order, for a layer on the card: ``None`` each on the CPU, whose
        sums take none, and ``None`` for the ``backward`` fields outside a
        gradient (``torch.is_grad_enabled()``), since those carry only the
        backward of gathers. ``shard``: as for :meth:`csr`."""
        if not self.senders.is_cuda:
            return (None,) * (len(forward) + len(backward))
        grad = torch.is_grad_enabled()
        return (tuple(self.csr(f, shard) for f in forward)
                + tuple(self.csr(f, shard) if grad else None for f in backward))


class GraphSample:
    """One host-side (numpy, unpadded) graph sample — the analog of PyG
    ``Data``; produced by dataset loaders and radius-graph construction,
    consumed by ``graphs.batching.collate``."""

    __slots__ = (
        "x", "pos", "senders", "receivers", "edge_attr", "edge_shifts",
        "graph_attr", "graph_y", "node_y", "energy_y", "forces_y",
        "dataset_id", "cell", "pbc", "extras",
    )

    def __init__(
        self,
        x: np.ndarray,
        pos: np.ndarray | None = None,
        senders: np.ndarray | None = None,
        receivers: np.ndarray | None = None,
        edge_attr: np.ndarray | None = None,
        edge_shifts: np.ndarray | None = None,
        graph_attr: np.ndarray | None = None,
        graph_y: np.ndarray | None = None,
        node_y: np.ndarray | None = None,
        energy_y: np.ndarray | None = None,
        forces_y: np.ndarray | None = None,
        dataset_id: int = 0,
        cell: np.ndarray | None = None,
        pbc: np.ndarray | None = None,
        extras: dict | None = None,
    ):
        self.x = np.asarray(x, dtype=np.float32)
        n = self.x.shape[0]
        self.pos = (
            np.asarray(pos, dtype=np.float32) if pos is not None else np.zeros((n, 3), np.float32)
        )
        self.senders = (
            np.asarray(senders, dtype=np.int32) if senders is not None else np.zeros((0,), np.int32)
        )
        self.receivers = (
            np.asarray(receivers, dtype=np.int32)
            if receivers is not None
            else np.zeros((0,), np.int32)
        )
        e = self.senders.shape[0]
        self.edge_attr = (
            np.asarray(edge_attr, dtype=np.float32)
            if edge_attr is not None
            else np.zeros((e, 0), np.float32)
        )
        self.edge_shifts = (
            np.asarray(edge_shifts, dtype=np.float32)
            if edge_shifts is not None
            else np.zeros((e, 3), np.float32)
        )
        self.graph_attr = (
            np.asarray(graph_attr, dtype=np.float32).reshape(-1)
            if graph_attr is not None
            else np.zeros((0,), np.float32)
        )
        self.graph_y = (
            np.asarray(graph_y, dtype=np.float32).reshape(-1)
            if graph_y is not None
            else np.zeros((0,), np.float32)
        )
        self.node_y = (
            np.asarray(node_y, dtype=np.float32).reshape(n, -1)
            if node_y is not None
            else np.zeros((n, 0), np.float32)
        )
        self.energy_y = (
            np.asarray(energy_y, dtype=np.float32).reshape(1)
            if energy_y is not None
            else np.zeros((1,), np.float32)
        )
        self.forces_y = (
            np.asarray(forces_y, dtype=np.float32).reshape(n, 3)
            if forces_y is not None
            else np.zeros((n, 3), np.float32)
        )
        self.dataset_id = int(dataset_id)
        self.cell = None if cell is None else np.asarray(cell, dtype=np.float64).reshape(3, 3)
        self.pbc = None if pbc is None else np.asarray(pbc, dtype=bool).reshape(3)
        self.extras = extras or {}

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"GraphSample(nodes={self.num_nodes}, edges={self.num_edges}, "
            f"x={self.x.shape}, graph_y={self.graph_y.shape}, node_y={self.node_y.shape})"
        )


__all__ = ["FIELDS", "NUM_ELEMENTS", "BatchMeta", "GraphBatch", "GraphSample", "loop_tail",
           "loop_tail_mask", "loop_tail_nodes"]
