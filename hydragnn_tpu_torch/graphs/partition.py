"""Spatial graph partitioning — Morton-ordered cell assignment + boundaries.

Counterpart of ``hydragnn_tpu/graphs/partition.py``, in numpy as there; its
plans are the JAX package's, array for array and dtype for dtype
(``tests/test_torch_partition.py``).

The halo-exchange route (``parallel/halo.py``) partitions ONE giant graph's
atoms over the mesh's data axis so that each device keeps its nodes, owned
edges, and node features resident, and only *boundary* node features cross
the interconnect. Partition quality is everything: the bytes a halo exchange
moves per layer are proportional to the number of atoms that sit within one
interaction cutoff of a partition boundary. This module produces partitions
whose boundaries are thin by construction:

* atoms are binned into the SAME spatial grid the fused cell-list uses
  (``md.plan_cell_grid`` geometry: grid dim = floor(cell height / cutoff)),
  with the binning formula of the JAX package's host-side mirror of its
  on-device binning;
* cells are ranked along a Morton (Z-order) space-filling curve, so cells
  that are adjacent in rank are adjacent in space — contiguous rank ranges
  make compact bricks, not slabs of maximal surface area;
* atoms are ordered by (cell Morton rank, atom id) and split into
  contiguous, count-balanced ranges — one per partition.

Everything here is host-side numpy at collate time (the partition feeds a
static exchange plan).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = [
    "PartitionPlan",
    "bounding_cell",
    "cell_assignment",
    "morton_codes",
    "partition_nodes",
    "boundary_sets",
]


def bounding_cell(pos: np.ndarray, margin: float = 1e-6) -> np.ndarray:
    """Axis-aligned bounding box as a diagonal cell matrix for OPEN (non
    periodic) structures that carry no lattice: the grid then spans exactly
    the occupied region. ``margin`` keeps atoms at the max corner strictly
    inside the box so they bin into the last cell, not one past it."""
    pos = np.asarray(pos, float)
    span = pos.max(axis=0) - pos.min(axis=0)
    return np.diag(np.maximum(span, margin) * (1.0 + margin))


def cell_assignment(
    pos: np.ndarray,
    grid: tuple[int, int, int],
    cell: np.ndarray,
    pbc=None,
    origin: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-atom spatial cell: ``(idx3 [N, 3] int32, cid [N] int32)``:
    fractional coords via the inverse cell, wrapped
    (``% 1``) on periodic axes / clamped to ``[0, 1)`` on open axes, scaled
    by the grid and clipped. ``origin`` shifts positions first (used with
    ``bounding_cell`` for structures whose box does not start at 0)."""
    pos = np.asarray(pos, float).reshape(-1, 3)
    cell = np.asarray(cell, float).reshape(3, 3)
    g = np.asarray(grid, np.int64).reshape(3)
    if (g < 1).any():
        raise ValueError(f"grid dims must be >= 1, got {tuple(grid)}")
    pbc_b = (
        np.ones(3, bool) if pbc is None else np.asarray(pbc, bool).reshape(3)
    )
    if origin is not None:
        pos = pos - np.asarray(origin, float).reshape(1, 3)
    frac = pos @ np.linalg.inv(cell)
    fw = np.where(pbc_b, frac % 1.0, np.clip(frac, 0.0, 1.0 - 1e-9))
    idx3 = np.clip((fw * g).astype(np.int64), 0, g - 1)
    cid = (idx3[:, 0] * g[1] + idx3[:, 1]) * g[2] + idx3[:, 2]
    return idx3.astype(np.int32), cid.astype(np.int32)


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Insert two zero bits between each bit of ``v`` (21-bit inputs)."""
    v = v.astype(np.uint64)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_codes(idx3: np.ndarray) -> np.ndarray:
    """Morton (Z-order) code per 3-D cell index: bits of x, y, z interleaved
    so nearby codes are nearby in space. Supports grids up to 2^21 per axis
    (uint64 codes)."""
    idx3 = np.asarray(idx3, np.int64).reshape(-1, 3)
    if (idx3 < 0).any() or (idx3 >= (1 << 21)).any():
        raise ValueError("morton_codes supports cell indices in [0, 2^21)")
    return (
        _spread_bits(idx3[:, 0]) << np.uint64(2)
    ) | (_spread_bits(idx3[:, 1]) << np.uint64(1)) | _spread_bits(idx3[:, 2])


class PartitionPlan(NamedTuple):
    """A spatial partition of one graph's nodes over ``n_parts`` devices.

    ``order``  — all node ids sorted by (Morton rank of their cell, id);
                 partition p owns the contiguous slice ``order[start[p] :
                 start[p + 1]]``.
    ``owner``  — per-node partition id, inverse view of ``order``/``start``.
    ``start``  — ``[n_parts + 1]`` slice offsets into ``order``.
    ``grid``   — the spatial grid the cells came from.
    ``cid``    — per-node flat cell id (diagnostics / MD reuse).
    """

    order: np.ndarray
    owner: np.ndarray
    start: np.ndarray
    grid: tuple[int, int, int]
    cid: np.ndarray

    @property
    def n_parts(self) -> int:
        return len(self.start) - 1

    def part(self, p: int) -> np.ndarray:
        """Global node ids owned by partition ``p`` (Morton order)."""
        return self.order[self.start[p] : self.start[p + 1]]


def _auto_grid(pos, cell, pbc, cutoff, n_parts) -> tuple[int, int, int]:
    """Grid for partitioning. With a cutoff, use the cell-list geometry
    (``md.plan_cell_grid``: floor(height / cutoff), so a 27-neighborhood
    covers all pairs); without one, or when that plan degenerates, fall back
    to a resolution with comfortably more cells than partitions so the
    Morton walk has something to order."""
    if cutoff is not None:
        from ..md import plan_cell_grid

        plan = plan_cell_grid(cell, cutoff, np.asarray(pos).shape[0], pbc=pbc)
        if plan is not None:
            return plan[0]
    side = max(int(np.ceil((max(n_parts, 2) * 8) ** (1.0 / 3.0))), 2)
    return (side, side, side)


def partition_nodes(
    pos: np.ndarray,
    n_parts: int,
    cell: np.ndarray | None = None,
    pbc=None,
    grid: tuple[int, int, int] | None = None,
    cutoff: float | None = None,
) -> PartitionPlan:
    """Split nodes into ``n_parts`` count-balanced, Morton-contiguous
    partitions. Deterministic: same inputs -> identical plan (ties broken by
    node id). Partition sizes differ by at most one node, so no partition is
    empty whenever ``N >= n_parts``."""
    pos = np.asarray(pos, float).reshape(-1, 3)
    n = pos.shape[0]
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    if n < n_parts:
        raise ValueError(
            f"cannot partition {n} nodes over {n_parts} partitions "
            "(every partition must own at least one node)"
        )
    origin = None
    if cell is None:
        cell = bounding_cell(pos)
        origin = pos.min(axis=0)
        pbc = np.zeros(3, bool)
    if grid is None:
        grid = _auto_grid(pos, cell, pbc, cutoff, n_parts)
    idx3, cid = cell_assignment(pos, grid, cell, pbc=pbc, origin=origin)
    codes = morton_codes(idx3)
    order = np.lexsort((np.arange(n), codes)).astype(np.int32)
    # contiguous equal split of the Morton-ordered walk: cells far apart in
    # rank are far apart in space, so each contiguous range is a compact brick
    sizes = np.full(n_parts, n // n_parts, np.int64)
    sizes[: n % n_parts] += 1
    start = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    owner = np.empty(n, np.int32)
    for p in range(n_parts):
        owner[order[start[p] : start[p + 1]]] = p
    return PartitionPlan(
        order=order, owner=owner, start=start,
        grid=tuple(int(g) for g in grid), cid=cid,
    )


def boundary_sets(
    senders: np.ndarray,
    receivers: np.ndarray,
    owner: np.ndarray,
    n_parts: int,
) -> dict[tuple[int, int], np.ndarray]:
    """Per ordered partition pair ``(src, dst)``: the sorted unique global
    ids of src-owned atoms that some dst-owned receiver reads through an
    edge — exactly the rows src must send into dst's halo slots before every
    conv layer. Pairs with no crossing edges are absent from the dict.

    Edges are assumed already owner-partitioned by RECEIVER (the halo
    scheme's invariant: a device owns every in-edge of its own nodes), so a
    sender whose owner differs from the receiver's owner is by definition a
    boundary atom of the receiver's partition."""
    senders = np.asarray(senders, np.int64).reshape(-1)
    receivers = np.asarray(receivers, np.int64).reshape(-1)
    owner = np.asarray(owner, np.int64).reshape(-1)
    src_own = owner[senders]
    dst_own = owner[receivers]
    cross = src_own != dst_own
    # unique (src, dst, sender) triples, lexicographically sorted — one
    # vectorized pass instead of a python loop over crossing edges
    triples = np.unique(
        np.stack([src_own[cross], dst_own[cross], senders[cross]], axis=1),
        axis=0,
    )
    out: dict[tuple[int, int], np.ndarray] = {}
    if triples.size == 0:
        return out
    pair_key = triples[:, 0] * n_parts + triples[:, 1]
    splits = np.nonzero(np.diff(pair_key))[0] + 1
    for chunk in np.split(triples, splits):
        out[(int(chunk[0, 0]), int(chunk[0, 1]))] = chunk[:, 2].astype(np.int32)
    return out
