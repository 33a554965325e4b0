"""Lennard-Jones synthetic MLIP dataset with analytic energies and forces.

Counterpart of ``hydragnn_tpu/datasets/lennard_jones.py`` (reference
``examples/LennardJones/LJ_data.py``): perturbed cubic lattices (lattice
constant 3.8, relative displacement 0.1) under PBC, with LJ(epsilon=1.0,
sigma=3.4) total energies and analytic forces, in numpy on the host. The
fixture for energy-conserving force training (forces from
``torch.autograd.grad`` must recover these).
"""

from __future__ import annotations

import numpy as np

from ..graphs.graph import GraphSample
from ..graphs.radius import radius_graph

LATTICE_CONSTANT = 3.8
EPSILON = 1.0
SIGMA = 3.4


def lj_energy_forces(
    pos: np.ndarray, senders, receivers, shifts, eps: float = EPSILON, sigma: float = SIGMA
) -> tuple[float, np.ndarray]:
    """Total energy (each pair counted once over directed edges via 0.5x) and
    per-atom analytic forces from the neighbor list."""
    vec = pos[receivers] - pos[senders] + shifts  # r_ij vectors (i=sender)
    r = np.linalg.norm(vec, axis=1)
    sr6 = (sigma / r) ** 6
    sr12 = sr6**2
    energy = 0.5 * np.sum(4.0 * eps * (sr12 - sr6))
    # dU/dr; force on sender i from j: -dU/dr * (pos_i - pos_j)/r = dU/dr * vec/r
    dudr = 4.0 * eps * (-12.0 * sr12 + 6.0 * sr6) / r
    f_edge = (dudr / r)[:, None] * vec  # force contribution on the sender
    forces = np.zeros_like(pos)
    np.add.at(forces, senders, f_edge)
    return float(energy), forces


def lennard_jones_data(
    number_configurations: int = 300,
    cells_per_dim: int = 3,
    radius: float = 5.0,
    max_neighbours: int = 100,
    relative_maximum_atomic_displacement: float = 0.1,
    seed: int = 0,
) -> list[GraphSample]:
    rng = np.random.default_rng(seed)
    a = LATTICE_CONSTANT
    n_side = cells_per_dim
    base = (
        np.stack(
            np.meshgrid(*(np.arange(n_side),) * 3, indexing="ij"), axis=-1
        ).reshape(-1, 3)
        * a
    )
    cell = np.eye(3) * (n_side * a)
    pbc = np.array([True, True, True])
    samples = []
    for _ in range(number_configurations):
        disp = rng.uniform(
            -relative_maximum_atomic_displacement,
            relative_maximum_atomic_displacement,
            size=base.shape,
        ) * a
        pos = base + disp
        s_idx, r_idx, shifts = radius_graph(
            pos, radius=radius, cell=cell, pbc=pbc, max_neighbours=max_neighbours
        )
        energy, forces = lj_energy_forces(pos, s_idx, r_idx, shifts)
        n = pos.shape[0]
        samples.append(
            GraphSample(
                x=np.ones((n, 1), np.float32),  # single atom type (LJ_data atom_types=[1])
                pos=pos,
                senders=s_idx,
                receivers=r_idx,
                edge_shifts=shifts,
                energy_y=np.array([energy], np.float32),
                forces_y=forces,
                cell=cell,
                pbc=pbc,
                extras={
                    "node_table": np.ones((n, 1), np.float32),
                    "graph_table": np.array([energy], np.float32),
                },
            )
        )
    return samples
