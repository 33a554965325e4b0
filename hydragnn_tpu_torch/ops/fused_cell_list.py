"""Cell-list radius graph: the MD neighbour rebuild.

Counterpart of ``hydragnn_tpu/ops/fused_cell_list.py`` and of the XLA build
it stands beside (``hydragnn_tpu/md.py::binned_radius_graph``). One kernel,
``csrc/cell_list.cu``, replaces the Pallas ``_cell_kernel``.

:func:`binned_radius_graph` (:func:`cell_list_edges` where the caller holds
the cell's geometry) has three parts:

* **prelude** (tensor code, shared by both routes): fractional coordinates
  ``pos @ inv``, wrapped on periodic axes and clamped on open ones, cell
  coordinates, cell ids, a stable sort by cell id, each cell's first sorted
  index and occupancy, and the largest occupancy;
* **the pair test**: every atom against the atoms of its 27 neighbour cells
  (``_CELL_OFFSETS`` order, at most ``capacity`` slots each), minimum-image
  displacement through the cell matrix and its inverse, kept where
  ``d^2 <= cutoff^2`` and not the atom itself. On a CUDA tensor this is the
  kernel: one launch that tests every pair once, scans the atoms' hit
  counts across CTAs (decoupled look-back), and writes the ids, each edge's
  shift and the edge count ``n_real``; one fill zeroes the shifts' buffer
  and the kernel's control words first. On a CPU tensor it is the plain
  version, the XLA build transliterated (the ``[n, 27 * capacity]``
  candidate matrix and ``torch.nonzero``), and the per-edge shifts are
  tensor code after it, from the same roundings;
* **epilogue** (tensor code): the edge mask, pad ids and the overflow
  poison of ``n_edges``.

Both routes emit the XLA build's edge order, array for array: by sender,
then by neighbour offset, then by rank in the cell. Senders come out
non-decreasing, and a ``max_edges`` truncation keeps the XLA build's prefix.
The Pallas kernel's cell-major order is not reproduced; every consumer sums
over edges, so nothing depends on it. The kernel route never waits for the
host: its outputs are sized by ``max_edges`` and ``n_edges`` stays on the
device, so an MD step can be captured whole.

Routing is by device and nothing else: a CUDA tensor launches the kernel
(float32 positions) or raises, a CPU tensor takes the plain version. There
is no flag, no cell cap and no route back to the plain version.

Products with the 3 x 3 matrices are written out as three terms,
``(v0 * m0 + v1 * m1) + v2 * m2``, each product and sum rounded on its own,
in the kernel and in the tensor code alike, so that a pair at
``d^2 ~ cutoff^2`` falls the same way on both routes.

The build carries no position gradient (ids are integers, shifts are
piecewise constant in the positions; the JAX package's shifts have gradient
0 too), so it runs under ``torch.no_grad``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..telemetry.ledger import kernel_region
from .fused_scatter import _count_launch, _raise_on, _route

# the 27 neighbour-cell offsets, in the JAX package's order (dz fastest)
_CELL_OFFSETS = np.array(list(itertools.product((-1, 0, 1), repeat=3)), np.int32)


def mat3(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``v @ m`` for row vectors ``v [..., 3]`` and ``m [3, 3]``, written as
    ``(v0 * m[0] + v1 * m[1]) + v2 * m[2]``: no matrix unit, no fused
    multiply-add, the same roundings on every device (the kernel's)."""
    return v[..., 0:1] * m[0] + v[..., 1:2] * m[1] + v[..., 2:3] * m[2]


def inverse3(m: torch.Tensor) -> torch.Tensor:
    """The inverse of a 3 x 3 matrix by its adjugate, as tensor code on
    ``m``'s device (no solver, nothing that waits for the host)."""
    c = [[m[(i + 1) % 3, (j + 1) % 3] * m[(i + 2) % 3, (j + 2) % 3]
          - m[(i + 1) % 3, (j + 2) % 3] * m[(i + 2) % 3, (j + 1) % 3]
          for j in range(3)] for i in range(3)]
    det = m[0, 0] * c[0][0] + m[0, 1] * c[0][1] + m[0, 2] * c[0][2]
    # inv[i][j] = cofactor[j][i] / det
    return torch.stack([torch.stack([c[j][i] for j in range(3)]) for i in range(3)]) / det


def geometry(cell, pbc, dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor,
                                                           torch.Tensor]:
    """``(cell [3, 3], its inverse, periodic axes as 1.0 / 0.0 [3])`` in
    ``dtype`` on ``device``. Pass tensors already on the device from an MD
    loop: a host array is copied on every call."""
    cellm = torch.as_tensor(cell, dtype=dtype, device=device).reshape(3, 3)
    pbcf = torch.as_tensor(pbc, device=device).reshape(3).to(dtype)
    return cellm, inverse3(cellm), pbcf


def _prelude(pos, cellm, inv, pbcf, grid, n_cells):
    """Cell coordinates ``[n, 3]``, the stable cell-sorted order, each
    cell's first sorted index and occupancy (int32), as
    ``md.py:254-267`` bins (``frac % 1.0`` a floor modulo; an open axis
    clamped to ``1 - 1e-9``, which is 1.0 in float32, then clipped to
    ``g - 1``)."""
    gx, gy, gz = grid
    frac = mat3(pos, inv)
    fw = torch.where(pbcf > 0, torch.remainder(frac, 1.0), torch.clamp(frac, 0.0, 1.0 - 1e-9))
    # per axis with Python ints: no host-to-device copy, so the build can be
    # captured in a CUDA graph
    idx3 = torch.stack([torch.clamp((fw[:, k] * grid[k]).to(torch.int32), 0, grid[k] - 1)
                        for k in range(3)], dim=1)
    cid = (idx3[:, 0] * gy + idx3[:, 1]) * gz + idx3[:, 2]
    cs, order = torch.sort(cid, stable=True)
    order = order.to(torch.int32)
    ids = torch.arange(n_cells, dtype=torch.int32, device=pos.device)
    start = torch.searchsorted(cs, ids, out_int32=True)
    occ = torch.searchsorted(cs, ids, right=True, out_int32=True) - start
    return idx3.contiguous(), order, cs, start, occ


def _check_int32(n: int, capacity: int) -> None:
    if n * 27 * capacity >= 2**31:
        # candidate indices and edge offsets are int32 (the JAX build's guard)
        raise ValueError(
            f"cell-list candidate matrix overflows int32 flat indices "
            f"(n={n} x 27 x capacity={capacity}); reduce capacity_factor or "
            "shard atoms over the mesh"
        )


def plain_cell_pairs(pos, cutoff, max_edges, cellm, inv, pbcf, grid, capacity, idx3, order,
                     cs):
    """The XLA build's pair test (``md.py:268-303``): slots, the
    ``[n, 27 * capacity]`` candidate matrix, minimum-image displacements,
    ``torch.nonzero``. Returns ``(senders, receivers, n_real)`` with
    ``max_edges`` slots (unused slots 0) and the untruncated edge count."""
    n = pos.shape[0]
    dev = pos.device
    gx, gy, gz = grid
    g = torch.tensor(grid, dtype=torch.int32, device=dev)
    n_cells = gx * gy * gz
    rank = torch.arange(n, dtype=torch.int32, device=dev) - torch.searchsorted(
        cs, cs, out_int32=True)
    slots = torch.full((n_cells, capacity), n, dtype=torch.int32, device=dev)
    # rank >= capacity overwrites the last slot; poisoned through max_occ
    slots[cs.long(), torch.clamp(rank, max=capacity - 1).long()] = order
    offs = torch.as_tensor(_CELL_OFFSETS, device=dev)
    nbr3 = idx3[:, None, :] + offs[None, :, :]
    wrapped = torch.remainder(nbr3, g)
    valid = ((pbcf > 0) | ((nbr3 >= 0) & (nbr3 < g))).all(-1)
    ncid = (wrapped[..., 0] * gy + wrapped[..., 1]) * gz + wrapped[..., 2]
    cand = torch.where(valid[..., None], slots[ncid.long()], n).reshape(n, 27 * capacity)
    pos_pad = torch.cat([pos, pos.new_zeros(1, 3)])
    disp = pos_pad[cand.long()] - pos[:, None, :]
    disp = disp - mat3(torch.round(mat3(disp, inv)) * pbcf, cellm)
    d2 = disp[..., 0] * disp[..., 0] + disp[..., 1] * disp[..., 1] + disp[..., 2] * disp[..., 2]
    c2 = torch.tensor(float(cutoff) * float(cutoff), dtype=pos.dtype, device=dev)
    within = ((d2 <= c2) & (cand != n)
              & (cand != torch.arange(n, dtype=torch.int32, device=dev)[:, None]))
    flat = torch.nonzero(within.reshape(-1)).reshape(-1)[:max_edges]
    senders = torch.zeros(max_edges, dtype=torch.int32, device=dev)
    receivers = torch.zeros(max_edges, dtype=torch.int32, device=dev)
    senders[: flat.shape[0]] = (flat // (27 * capacity)).to(torch.int32)
    receivers[: flat.shape[0]] = cand.reshape(-1)[flat]
    return senders, receivers, within.sum().to(torch.int32)


def cost(atoms: int, cells: int, edges: int, candidates: int) -> tuple[int, int]:
    """``(operations, bytes)`` of one pair test: every candidate pair tested
    once (~48 fp32 operations: two 3 x 3 products, three roundings, the
    displacement and d^2), each input read once (positions, cell
    coordinates, sort order: 28 B per atom; the cell table: 8 B per cell;
    the cell and its inverse, the periodic axes: 84 B), each edge written
    once (8 B)."""
    return 48 * candidates, 28 * atoms + 8 * cells + 8 * edges + 21 * 4


def _kernel_cell_pairs(pos, cutoff, max_edges, cellm, inv, pbcf, grid, capacity,
                       idx3, order, start, occ):
    """The same pairs from the B5 kernel, in one launch that also writes
    each edge's shift: ``(senders, receivers, shifts, n_real)``, the live
    slots written (those at or past ``max_edges`` dropped), the dead slots'
    shifts 0 and their ids unwritten. One buffer, zeroed by one fill, holds
    the kernel's control words (a look-back flag per CTA and the ticket),
    ``n_real`` and the shifts. Counted once as ``cell_list``."""
    name = "cell_list"
    if pos.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 positions, got {pos.dtype}")
    n = pos.shape[0]
    dev = pos.device
    from ._build import load

    lib = load()
    n_ctas = -(-n // lib.cell_list_atoms_per_cta())
    # [flags (2 int32 each) | ticket | n_real | shifts (3 per slot)]
    control = 2 * n_ctas + 2
    buf = torch.zeros(control + 3 * max_edges, dtype=torch.int32, device=dev)
    ids = torch.empty(2, max_edges, dtype=torch.int32, device=dev)
    senders, receivers = ids[0], ids[1]
    n_real = buf[control - 1]
    shifts = buf[control:].view(torch.float32).view(max_edges, 3)
    pos = pos.contiguous()
    inv, cellm, pbcf = (t.to(torch.float32).contiguous() for t in (inv, cellm, pbcf))
    c2 = float(np.float32(float(cutoff) * float(cutoff)))
    _raise_on(name, lib.cell_list_edges(
        pos.data_ptr(), inv.data_ptr(), cellm.data_ptr(), pbcf.data_ptr(), idx3.data_ptr(),
        order.data_ptr(), start.data_ptr(), occ.data_ptr(), n, grid[0], grid[1], grid[2],
        capacity, c2, max_edges, senders.data_ptr(), receivers.data_ptr(), shifts.data_ptr(),
        n_real.data_ptr(), buf.data_ptr(), buf[control - 2].data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    _count_launch(name)
    return senders, receivers, shifts, n_real


def binned_radius_graph(pos: torch.Tensor, cutoff: float, max_edges: int, cell, pbc,
                        grid: tuple[int, int, int], capacity: int, pad_id: int = 0):
    """Cell-list radius graph with static shapes, O(N x 27 x capacity)
    memory: the contract of ``md.dynamic_radius_graph``, the same edges in
    the JAX XLA build's order (by sender, then neighbour offset, then rank
    in the cell). Returns ``(senders, receivers, shifts, edge_mask,
    n_edges)``: ids int32 ``[max_edges]`` (pads at ``pad_id``), shifts
    ``[max_edges, 3]`` (``pos[r] - pos[s] + shift`` is the edge vector),
    ``edge_mask`` in ``pos.dtype``, ``n_edges`` an int32 0-d tensor on the
    device: the true edge count, or ``max_edges + max_occupancy`` when a
    cell holds more than ``capacity`` atoms, so the caller's ``n_edges <=
    max_edges`` check trips. ``grid`` and ``capacity`` come from
    ``md.plan_cell_grid``. On the card this launches the cell-list kernel
    (float32 positions) or raises."""
    return cell_list_edges(pos, cutoff, max_edges, geometry(cell, pbc, pos.dtype, pos.device),
                           grid, capacity, pad_id=pad_id)


def cell_list_edges(pos: torch.Tensor, cutoff: float, max_edges: int, geo, grid, capacity: int,
                    pad_id: int = 0):
    """:func:`binned_radius_graph` with the cell given as ``geo = (cell,
    its inverse, periodic axes)`` from :func:`geometry`, on ``pos``'s
    device: an MD loop computes it once, not at every rebuild."""
    n = pos.shape[0]
    gx, gy, gz = (int(v) for v in grid)
    grid = (gx, gy, gz)
    capacity = int(capacity)
    n_cells = gx * gy * gz
    _check_int32(n, capacity)
    cellm, inv, pbcf = geo
    with torch.no_grad():
        pos = pos.detach()
        idx3, order, cs, start, occ = _prelude(pos, cellm, inv, pbcf, grid, n_cells)
        # a counting ledger takes the shapes' most (every cell full, every
        # slot an edge): the data's counts would wait for the card
        with kernel_region("cell_list", lambda: cost(n, n_cells, max_edges,
                                                     n * 27 * capacity)):
            if _route("cell_list", pos):
                senders, receivers, shifts, n_real = _kernel_cell_pairs(
                    pos, cutoff, max_edges, cellm, inv, pbcf, grid, capacity, idx3, order,
                    start, occ)
            else:
                senders, receivers, n_real = plain_cell_pairs(
                    pos, cutoff, max_edges, cellm, inv, pbcf, grid, capacity, idx3, order, cs)
                shifts = None
        live = torch.arange(max_edges, device=pos.device) < n_real
        edge_mask = live.to(pos.dtype)
        if shifts is None:
            disp = pos[receivers.long()] - pos[senders.long()]
            shifts = -mat3(torch.round(mat3(disp, inv)) * pbcf, cellm) * edge_mask[:, None]
        senders = torch.where(live, senders, pad_id).to(torch.int32)
        receivers = torch.where(live, receivers, pad_id).to(torch.int32)
        max_occ = occ.max()
        n_edges = torch.where(max_occ > capacity, max_edges + max_occ, n_real).to(torch.int32)
    return senders, receivers, shifts, edge_mask, n_edges


__all__ = ["binned_radius_graph", "cell_list_edges", "cost", "geometry", "inverse3", "mat3",
           "plain_cell_pairs"]
