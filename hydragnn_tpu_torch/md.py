"""Molecular dynamics on the card, with analytic potentials or MLIP models.

Counterpart of ``hydragnn_tpu/md.py``. The neighbour list is rebuilt every
step on the device:

* :func:`dynamic_radius_graph`: the dense O(N^2) minimum-image build with
  static output shapes (plain tensor code; there is no kernel here in the
  JAX package either). Its pairs are compacted at a static size (a
  cumulative sum of the pair mask, searched for each edge slot), in
  ``torch.nonzero``'s order, so nothing waits for the host;
* :func:`binned_radius_graph` with :func:`plan_cell_grid`: the cell list,
  O(N x 27 x capacity), through ``ops.fused_cell_list``: the hand-written
  kernel B5 on the card (nothing waits for the host), the XLA build
  transliterated on the CPU. Both emit the JAX XLA build's arrays.

The integrators (velocity Verlet NVE, Langevin BAOAB NVT, Berendsen NPT)
take forces from ``torch.autograd.grad`` of any energy function
``energy_fn(pos, senders, receivers, shifts, edge_mask) -> scalar``, such as
an MLIP model's (:func:`mlip_energy_fn`). Where the JAX package rolls a
trajectory in one ``lax.scan``, :func:`run_md` on the card captures one
segment of ``record_every`` steps as a CUDA graph and replays it (the CPU
runs the steps one by one), and returns the recorded states stacked. The
states' ``n_edges`` and ``max_n_edges`` stay on the device; read them at
record points (the running ``max_n_edges`` once after the trajectory).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .ops.fused_cell_list import binned_radius_graph, cell_list_edges, geometry, mat3


@dataclasses.dataclass
class MDConfig:
    """The top-level ``MD`` config block; these field defaults are the
    schema defaults (``config/schema.py`` validates the block against them).

    ``fused_cell_list`` is validated and has no effect: the JAX package
    picks between its Pallas kernel and its XLA build there, while the port
    has one route per device (the kernel on the card, the plain version on
    the CPU), and both emit the XLA build's arrays."""

    neighbor: str = "auto"          # dense | cell | auto (see make_md_step)
    capacity_factor: float = 2.5    # plan_cell_grid per-cell slot headroom
    fused_cell_list: bool | None = None

    @staticmethod
    def from_config(config: dict | None) -> "MDConfig":
        """Read a full config dict's ``MD`` block (absent = defaults)."""
        block = (config or {}).get("MD") or {}
        unknown = set(block) - set(md_config_defaults())
        if unknown:
            raise ValueError(
                f"Unknown MD key(s) {sorted(unknown)}; known: {sorted(md_config_defaults())}"
            )
        return MDConfig(**block).validate()

    def validate(self) -> "MDConfig":
        if self.neighbor not in ("auto", "cell", "dense"):
            raise ValueError(
                f"MD.neighbor must be 'auto', 'cell', or 'dense', got {self.neighbor!r}"
            )
        if float(self.capacity_factor) <= 1.0:
            raise ValueError(
                "MD.capacity_factor must be > 1 (per-cell slot headroom), "
                f"got {self.capacity_factor}"
            )
        if self.fused_cell_list is not None and not isinstance(self.fused_cell_list, bool):
            raise ValueError(
                f"MD.fused_cell_list must be true/false/null, got {self.fused_cell_list!r}"
            )
        return self

    def step_kwargs(self) -> dict:
        """Kwargs for ``make_md_step`` / ``make_langevin_step`` / ``run_md``."""
        return {"neighbor": self.neighbor, "capacity_factor": float(self.capacity_factor)}


def md_config_defaults() -> dict:
    return dataclasses.asdict(MDConfig())


def _dense_flat_guard(n: int) -> None:
    if n * n >= 2**31:
        # the flat pair indices are int32 in the JAX build
        raise ValueError(
            f"dense neighbor build overflows int32 flat indices at n={n}; "
            "use the binned cell list (binned_radius_graph / neighbor='cell')"
        )


def dynamic_radius_graph(pos: torch.Tensor, cutoff: float, max_edges: int, cell=None, pbc=None,
                         pad_id: int = 0):
    """Directed radius graph with static shapes, from the dense distance
    matrix: ``(senders, receivers, shifts, edge_mask, n_edges)`` as in the
    JAX package. Ids are int32 ``[max_edges]``, pads point at ``pad_id``
    with ``edge_mask`` 0; ``shifts`` are the Cartesian minimum-image shift
    vectors (``pos[r] - pos[s] + shift`` is the edge vector); ``n_edges`` is
    the true count (an int32 0-d tensor; callers check ``n_edges <=
    max_edges``, an overflow keeps the nearest-by-index prefix). Periodic
    only when both ``cell`` and ``pbc`` are given; one image per pair, valid
    while the cutoff is under half the smallest cell height."""
    geo = None if cell is None or pbc is None else geometry(cell, pbc, pos.dtype, pos.device)
    return _dense_edges(pos, cutoff, max_edges, geo, pad_id)


def _dense_edges(pos, cutoff, max_edges, geo, pad_id):
    """:func:`dynamic_radius_graph` with the cell as :func:`geometry`'s
    ``(cell, inverse, periodic axes)`` on ``pos``'s device, or None."""
    n = pos.shape[0]
    _dense_flat_guard(n)
    with torch.no_grad():
        pos = pos.detach()
        dev = pos.device
        disp = pos[None, :, :] - pos[:, None, :]  # [s, r, 3] = pos[r] - pos[s]
        shift = torch.zeros_like(disp)
        if geo is not None:
            cellm, inv, pbcf = geo
            shift = -mat3(torch.round(mat3(disp, inv)) * pbcf, cellm)
            disp = disp + shift
        d2 = disp[..., 0] * disp[..., 0] + disp[..., 1] * disp[..., 1] + disp[..., 2] * disp[..., 2]
        c2 = torch.full((), float(cutoff) * float(cutoff), dtype=pos.dtype, device=dev)
        within = (d2 <= c2) & ~torch.eye(n, dtype=torch.bool, device=dev)
        flat, n_edges = compact_pairs(within.reshape(-1), max_edges)
        live = torch.arange(max_edges, device=dev) < n_edges
        edge_mask = live.to(pos.dtype)
        senders = (flat // n).to(torch.int32)
        receivers = (flat % n).to(torch.int32)
        shifts = shift[senders.long(), receivers.long()] * edge_mask[:, None]
        senders = torch.where(live, senders, pad_id).to(torch.int32)
        receivers = torch.where(live, receivers, pad_id).to(torch.int32)
    return senders, receivers, shifts, edge_mask, n_edges


def compact_pairs(mask: torch.Tensor, max_edges: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(the first max_edges indices where the 1-D bool mask holds, in
    increasing order, zero-padded to max_edges; their count as int32)``:
    ``torch.nonzero(mask)[:max_edges]`` at a static size. Slot ``k`` holds
    the first index whose running count of the mask reaches ``k + 1``; no
    size is read back on the host, so a CUDA graph can hold it."""
    counts = torch.cumsum(mask, 0)
    slots = torch.arange(1, max_edges + 1, dtype=counts.dtype, device=mask.device)
    flat = torch.searchsorted(counts, slots)
    flat = torch.where(flat < mask.shape[0], flat, 0)
    return flat, counts[-1].to(torch.int32)


def plan_cell_grid(cell, cutoff: float, n_atoms: int, capacity_factor: float = 2.5,
                   pbc=None) -> tuple[tuple[int, int, int], int] | None:
    """Host-side cell-list plan: the grid along each axis (perpendicular
    cell height over the cutoff, floored) and the per-cell slot capacity
    (mean occupancy x ``capacity_factor``, + 2). A periodic axis needs at
    least 3 cells (fewer would alias the +-1 offsets under the wrap): the
    plan is then None. An open axis bins with 1-2 cells. ``pbc`` None means
    fully periodic."""
    cell = np.asarray(cell, float).reshape(3, 3)
    pbc = np.ones(3, bool) if pbc is None else np.asarray(pbc, bool).reshape(3)
    vol = abs(np.linalg.det(cell))
    if vol <= 0:
        return None
    heights = np.array([
        vol / np.linalg.norm(np.cross(cell[(i + 1) % 3], cell[(i + 2) % 3])) for i in range(3)
    ])
    grid = np.floor(heights / float(cutoff)).astype(int)
    if (grid[pbc] < 3).any():
        return None
    grid = np.maximum(grid, 1)
    n_cells = int(grid.prod())
    cap = int(np.ceil(n_atoms / n_cells * capacity_factor)) + 2
    return (int(grid[0]), int(grid[1]), int(grid[2])), cap


class MDState(NamedTuple):
    pos: torch.Tensor          # [N, 3]
    vel: torch.Tensor          # [N, 3]
    forces: torch.Tensor       # [N, 3]
    energy: torch.Tensor       # scalar potential energy
    n_edges: torch.Tensor      # neighbour count of the last rebuild
    max_n_edges: torch.Tensor  # running max over the trajectory: the overflow telltale


def _energy_and_grad(energy_fn, pos, graph):
    """``(energy, dE/dpos)`` of ``energy_fn`` at ``pos`` on the edges
    ``graph``, both detached."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        e = energy_fn(p, *graph)
        (g,) = torch.autograd.grad(e, p)
    return e.detach(), g


def _make_potential_and_init(energy_fn, cutoff, max_edges, cell, pbc, pad_id, neighbor="auto",
                             capacity_factor=2.5):
    """The graph-rebuild potential ``pos -> (energy, forces, n_edges)`` and
    the initial-state constructor shared by the integrators.

    ``neighbor``: "dense" = the O(N^2) build, "cell" = the cell list
    (requires a periodic ``cell`` big enough for a 3 x 3 x 3 grid; raises
    otherwise), "auto" = the cell list when plannable and N >= 512, else
    dense. ``capacity_factor``: per-cell slot headroom for
    :func:`plan_cell_grid`; raise it after an ``n_edges`` overflow."""
    if neighbor not in ("auto", "cell", "dense"):
        raise ValueError(f"neighbor={neighbor!r}: expected 'auto', 'cell', or 'dense'")
    placed = {}

    def setup(pos):
        # once per run (the atom count, the cell and the device do not
        # change under NVE and NVT): the cell plan on the host, and the
        # cell, its inverse and the periodic axes on the positions' device
        key = (pos.shape[0], pos.dtype, pos.device)
        if placed.get("key") != key:
            periodic = cell is not None and pbc is not None
            geo = geometry(np.asarray(cell), np.asarray(pbc, bool), pos.dtype,
                           pos.device) if periodic else None
            spec = None
            if neighbor in ("auto", "cell") and periodic:
                spec = plan_cell_grid(np.asarray(cell), cutoff, pos.shape[0],
                                      capacity_factor=capacity_factor, pbc=np.asarray(pbc))
            if neighbor == "cell" and spec is None:
                raise ValueError(
                    "neighbor='cell' needs a periodic cell with every perpendicular height "
                    ">= 3*cutoff (plan_cell_grid returned None); use neighbor='dense' for "
                    "small boxes"
                )
            if neighbor == "auto" and pos.shape[0] < 512:
                spec = None
            placed.update(key=key, geo=geo, spec=spec)
        return placed["geo"], placed["spec"]

    def build(pos):
        geo, spec = setup(pos)
        if spec is not None:
            return cell_list_edges(pos, cutoff, max_edges, geo, spec[0], spec[1], pad_id=pad_id)
        return _dense_edges(pos, cutoff, max_edges, geo, pad_id)

    def potential(pos):
        s, r, sh, em, ne = build(pos)
        e, g = _energy_and_grad(energy_fn, pos, (s, r, sh, em))
        return e, -g, ne

    def init(pos, vel) -> MDState:
        e, f, ne = potential(pos)
        return MDState(pos=pos, vel=vel, forces=f, energy=e, n_edges=ne, max_n_edges=ne)

    potential.build = build
    potential.geometry = lambda pos: setup(pos)[0]
    return potential, init


def _wrap_positions(pos, geo):
    """Positions wrapped into the cell along periodic axes (the same
    three-term products as the neighbour builds); ``geo`` is
    :func:`geometry`'s ``(cell, inverse, periodic axes)``, or None."""
    if geo is None:
        return pos
    cellm, inv, pbcf = geo
    frac = mat3(pos, inv)
    frac = torch.where(pbcf > 0, torch.remainder(frac, 1.0), frac)
    return mat3(frac, cellm)


def _masses(masses, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(masses, dtype=like.dtype, device=like.device).reshape(-1, 1)


def make_md_step(energy_fn: Callable, masses, dt: float, cutoff: float, max_edges: int,
                 cell=None, pbc=None, pad_id: int = 0, neighbor: str = "auto",
                 capacity_factor: float = 2.5):
    """Velocity-Verlet step with a neighbour rebuild every step. Returns
    ``(init, step)``: ``init(pos, vel) -> MDState``, ``step(state) ->
    MDState``. Forces are ``-torch.autograd.grad`` of ``energy_fn(pos,
    senders, receivers, shifts, edge_mask)`` (a scalar). ``pad_id``: where
    padded edge slots point (an MLIP template's dummy node ``n_node - 1``).
    ``neighbor``: see :func:`_make_potential_and_init`."""
    potential, init = _make_potential_and_init(energy_fn, cutoff, max_edges, cell, pbc, pad_id,
                                               neighbor=neighbor,
                                               capacity_factor=capacity_factor)
    placed = {}

    def step(state: MDState) -> MDState:
        with torch.no_grad():
            if "m" not in placed:
                placed["m"] = _masses(masses, state.pos)
            m = placed["m"]
            vel_half = state.vel + 0.5 * dt * state.forces / m
            pos = _wrap_positions(state.pos + dt * vel_half, potential.geometry(state.pos))
            e, forces, ne = potential(pos)
            vel = vel_half + 0.5 * dt * forces / m
            return MDState(pos=pos, vel=vel, forces=forces, energy=e, n_edges=ne,
                           max_n_edges=torch.maximum(state.max_n_edges, ne))

    return init, step


def run_md(energy_fn: Callable, pos, vel, masses, dt: float, n_steps: int, cutoff: float,
           max_edges: int, cell=None, pbc=None, record_every: int = 1, pad_id: int = 0,
           neighbor: str = "auto", capacity_factor: float = 2.5):
    """Roll a trajectory: ``n_steps`` velocity-Verlet steps, every
    ``record_every``-th state recorded. Returns ``(final state, recorded
    states)``, the latter an ``MDState`` of tensors stacked on a leading
    axis of ``n_steps // record_every``. On the card one segment of
    ``record_every`` steps is captured as a CUDA graph
    (``capture.SegmentGraph``) and replayed once per recorded state; its
    answers are the eager steps' (``make_md_step``), bit for bit."""
    if n_steps % record_every:
        raise ValueError(
            f"n_steps={n_steps} must be a multiple of record_every={record_every} "
            "(the remainder would be dropped)"
        )
    init, step = make_md_step(energy_fn, masses, dt, cutoff, max_edges, cell=cell, pbc=pbc,
                              pad_id=pad_id, neighbor=neighbor,
                              capacity_factor=capacity_factor)
    state = init(torch.as_tensor(pos), torch.as_tensor(vel))
    recorded = []
    if state.pos.is_cuda:
        # the JAX package's scan: one captured segment of record_every
        # steps, replayed; each replay's end state is the recorded one
        from .capture import SegmentGraph

        segment = SegmentGraph(step, state, record_every, name="run_md")
        for _ in range(n_steps // record_every):
            recorded.append(segment.run())
        state = recorded[-1] if recorded else state
    else:
        for k in range(n_steps):
            state = step(state)
            if (k + 1) % record_every == 0:
                recorded.append(state)
    return state, MDState(*(torch.stack(field) for field in zip(*recorded)))


def make_langevin_step(energy_fn: Callable, masses, dt: float, cutoff: float, max_edges: int,
                       temperature: float, friction: float = 1.0, cell=None, pbc=None,
                       pad_id: int = 0, neighbor: str = "auto", capacity_factor: float = 2.5):
    """NVT Langevin integrator (BAOAB): the velocity-Verlet halves around an
    exact Ornstein-Uhlenbeck velocity kick. ``temperature`` is k_B T in
    energy units. ``step(state, generator) -> (state, generator)``: the
    noise is drawn from the explicit ``torch.Generator`` (on the state's
    device), which advances; it cannot reproduce ``jax.random``'s draws."""
    c1 = math.exp(-friction * dt)
    c2 = math.sqrt(temperature * (1.0 - c1 * c1))
    potential, init = _make_potential_and_init(energy_fn, cutoff, max_edges, cell, pbc, pad_id,
                                               neighbor=neighbor,
                                               capacity_factor=capacity_factor)
    placed = {}

    def step(state: MDState, generator: torch.Generator):
        with torch.no_grad():
            if "m" not in placed:
                placed["m"] = _masses(masses, state.pos)
            m = placed["m"]
            vel = state.vel + 0.5 * dt * state.forces / m                 # B
            pos = state.pos + 0.5 * dt * vel                                # A
            noise = torch.randn(vel.shape, generator=generator, dtype=vel.dtype,
                                device=vel.device)
            vel = c1 * vel + c2 * torch.sqrt(1.0 / m) * noise               # O (exact OU)
            pos = _wrap_positions(pos + 0.5 * dt * vel, potential.geometry(pos))  # A
            e, forces, ne = potential(pos)
            vel = vel + 0.5 * dt * forces / m                               # B
            return (MDState(pos=pos, vel=vel, forces=forces, energy=e, n_edges=ne,
                            max_n_edges=torch.maximum(state.max_n_edges, ne)), generator)

    return init, step


class NPTState(NamedTuple):
    pos: torch.Tensor          # [N, 3]
    vel: torch.Tensor          # [N, 3]
    forces: torch.Tensor       # [N, 3]
    energy: torch.Tensor       # scalar potential energy
    cell: torch.Tensor         # [3, 3], evolves under the barostat
    pressure: torch.Tensor     # instantaneous pressure of the last step
    temperature: torch.Tensor  # instantaneous kinetic temperature (energy units)
    n_edges: torch.Tensor
    max_n_edges: torch.Tensor


def make_berendsen_npt_step(energy_fn: Callable, masses, dt: float, cutoff: float,
                            max_edges: int, temperature: float, pressure: float,
                            tau_t: float = 0.1, tau_p: float = 1.0,
                            compressibility: float = 1.0, pbc=None, pad_id: int = 0,
                            max_scale_step: float = 0.02):
    """NPT by Berendsen weak coupling: a velocity-Verlet step, then a
    velocity rescale toward ``temperature`` (k_B T) and an isotropic rescale
    of positions and cell toward ``pressure``.

    The virial is the derivative of the energy with respect to a scalar
    strain on the step's fixed neighbour list, from the same backward pass
    as the forces: ``U(eps) = energy_fn((1+eps) pos, ..., (1+eps) shifts)``,
    ``P = (2 KE - dU/deps) / (3 V)``. The cell is state here, so the
    neighbours come from the dense build; each step's rescale factors are
    clipped to ``1 +- max_scale_step``. ``init(pos, vel, cell)``,
    ``step(state)``."""
    pbc_arr = np.ones(3, bool) if pbc is None else np.asarray(pbc, bool).reshape(3)
    placed = {}

    def masses_on(like):
        if "m" not in placed:
            placed["m"] = _masses(masses, like)
            placed["pbc"] = torch.as_tensor(pbc_arr, device=like.device)
        return placed["m"], placed["pbc"]

    def energy_virial(pos, geo):
        s, r, sh, em, ne = _dense_edges(pos, cutoff, max_edges, geo, pad_id)
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            eps = torch.zeros((), dtype=pos.dtype, device=pos.device, requires_grad=True)
            sc = 1.0 + eps
            e = energy_fn(sc * p, s, r, sc * sh, em)
            gpos, geps = torch.autograd.grad(e, (p, eps))
        return e.detach(), -gpos, geps, ne

    def t_and_p(vel, geps, cell):
        m, _ = masses_on(vel)
        vol = torch.abs(torch.linalg.det(cell))
        return temperature_of(vel, m), (2.0 * kinetic_energy(vel, m) - geps) / (3.0 * vol)

    def init(pos, vel, cell) -> NPTState:
        pos = torch.as_tensor(pos)
        vel = torch.as_tensor(vel)
        cell = torch.as_tensor(cell, dtype=pos.dtype, device=pos.device).reshape(3, 3)
        with torch.no_grad():
            _, pbc_t = masses_on(pos)
            e, f, geps, ne = energy_virial(pos, geometry(cell, pbc_t, pos.dtype, pos.device))
            t_i, p_i = t_and_p(vel, geps, cell)
        return NPTState(pos=pos, vel=vel, forces=f, energy=e, cell=cell, pressure=p_i,
                        temperature=t_i, n_edges=ne, max_n_edges=ne)

    def step(state: NPTState) -> NPTState:
        with torch.no_grad():
            m, pbc_t = masses_on(state.pos)
            # the cell evolves: its geometry once per step, for the wrap and
            # the rebuild
            geo = geometry(state.cell, pbc_t, state.pos.dtype, state.pos.device)
            vel_half = state.vel + 0.5 * dt * state.forces / m
            pos = _wrap_positions(state.pos + dt * vel_half, geo)
            e, forces, geps, ne = energy_virial(pos, geo)
            vel = vel_half + 0.5 * dt * forces / m
            t_inst, p_inst = t_and_p(vel, geps, state.cell)
            # weak couplings, clipped (the Berendsen stability guard); the
            # pressure bracket is clipped before the cube root, which would
            # be NaN for a negative bracket
            lam = torch.sqrt(torch.clamp(
                1.0 + dt / tau_t * (temperature / torch.clamp(t_inst, min=1e-12) - 1.0),
                0.81, 1.21))
            mu = torch.clamp(
                1.0 - compressibility * dt / tau_p * (pressure - p_inst),
                (1.0 - max_scale_step) ** 3, (1.0 + max_scale_step) ** 3) ** (1.0 / 3.0)
            return NPTState(pos=pos * mu, vel=vel * lam, forces=forces, energy=e,
                            cell=state.cell * mu, pressure=p_inst, temperature=t_inst,
                            n_edges=ne, max_n_edges=torch.maximum(state.max_n_edges, ne))

    return init, step


def kinetic_energy(vel: torch.Tensor, masses) -> torch.Tensor:
    m = _masses(masses, vel)
    return 0.5 * torch.sum(m * vel * vel)


def temperature_of(vel: torch.Tensor, masses) -> torch.Tensor:
    """Instantaneous kinetic temperature in energy units (k_B T):
    2 KE / (3 N)."""
    return 2.0 * kinetic_energy(vel, masses) / (3.0 * vel.shape[0])


def mlip_energy_fn(model, template) -> Callable:
    """An MLIP model's energy (``models.mlip``) as an MD ``energy_fn``.
    ``template`` is a single-graph ``GraphBatch`` on the model's device,
    collated with ``n_edge = max_edges`` (e.g. ``PadSpec(n_node=n + 8,
    n_edge=max_edges, n_graph=2)``): it supplies the node features and
    masks, and every call puts the integrated positions of its real atoms
    and the current neighbour arrays in. Pass ``pad_id = n_node - 1`` (the
    template's dummy node) to the rebuild. Per-edge attributes are refused:
    they would describe the template's topology, not the evolving one."""
    from .models.mlip import make_graph_energy_fn

    if template.edge_attr.shape[-1]:
        raise ValueError(
            "template carries per-edge attributes; they describe the template's topology, "
            "not the evolving neighbor list — use an edge_attr-free config for MD"
        )
    graph_energy = make_graph_energy_fn(model)
    n_real = int(template.node_mask.sum())
    pad_pos = template.pos[n_real:]

    def energy(pos_real, senders, receivers, shifts, edge_mask):
        # a concatenation, not an in-place write: the energy stays
        # differentiable in the integrated positions
        pos_full = torch.cat([pos_real.to(pad_pos.dtype), pad_pos])
        b = template.replace(
            pos=pos_full, senders=senders, receivers=receivers, edge_shifts=shifts,
            edge_mask=edge_mask,
            # the template's sortedness certificates describe its own edges;
            # the CSR views of these are built from scratch
            meta=None,
        )
        return graph_energy(b).sum()

    return energy


__all__ = [
    "MDConfig", "MDState", "NPTState", "binned_radius_graph", "compact_pairs",
    "dynamic_radius_graph",
    "kinetic_energy", "make_berendsen_npt_step", "make_langevin_step", "make_md_step",
    "md_config_defaults", "mlip_energy_fn", "plan_cell_grid", "run_md", "temperature_of",
]
