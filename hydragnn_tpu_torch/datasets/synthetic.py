"""Deterministic synthetic BCC dataset — the convergence-test fixture.

The port's own copy of ``hydragnn_tpu/datasets/synthetic.py`` (numpy only;
the CPU tests hold its arrays equal to the JAX package's). Random BCC
supercells (2 atoms per conventional cell), integer node types, nodal outputs
built from a k-nearest-neighbor average ``x`` of the types (simulating one
round of message passing so the targets are learnable by a GNN):

    NODAL_OUTPUT1 = x
    NODAL_OUTPUT2 = x^2 + type
    NODAL_OUTPUT3 = x^3
    GLOBAL_OUTPUT = sum over nodes of (out1 + out2 + out3)

The generated ``GraphSample``s carry full feature tables in ``extras``
(``node_table`` columns: [type, out1, out2, out3]; ``graph_table``: [total]);
``apply_variables_of_interest`` (preprocess) then selects model inputs/targets
per the config — the analog of the reference's raw-loader +
``update_predicted_values`` column selection.
"""

from __future__ import annotations

import numpy as np

from ..graphs.graph import GraphSample
from ..graphs.radius import radius_graph


def _bcc_positions(uc_x: int, uc_y: int, uc_z: int) -> np.ndarray:
    grid = np.stack(
        np.meshgrid(np.arange(uc_x), np.arange(uc_y), np.arange(uc_z), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3).astype(np.float64)
    corner = grid
    center = grid + 0.5
    # interleave corner/center like the reference's count_pos ordering
    pos = np.empty((corner.shape[0] * 2, 3), np.float64)
    pos[0::2] = corner
    pos[1::2] = center
    return pos


def _knn_average(pos: np.ndarray, values: np.ndarray, k: int) -> np.ndarray:
    """Mean of each node's k nearest neighbors' values (including self at
    distance 0 — sklearn KNeighborsRegressor.predict on the training points
    includes the point itself, matching reference :128-131)."""
    d2 = np.sum((pos[None, :, :] - pos[:, None, :]) ** 2, axis=-1)
    nearest = np.argsort(d2, axis=1)[:, :k]
    return values[nearest].mean(axis=1)


def deterministic_graph_data(
    number_configurations: int = 500,
    unit_cell_x_range=(1, 3),
    unit_cell_y_range=(1, 3),
    unit_cell_z_range=(1, 2),
    number_types: int = 3,
    number_neighbors: int = 2,
    linear_only: bool = False,
    radius: float = 2.0,
    max_neighbours: int | None = 100,
    seed: int = 0,
) -> list[GraphSample]:
    """Generate the synthetic dataset as ``GraphSample``s with radius graphs
    attached (the reference writes LSMS text files and re-reads them; we keep
    the text round-trip in the LSMS loader tests instead of the hot path)."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(number_configurations):
        uc_x = int(rng.integers(unit_cell_x_range[0], unit_cell_x_range[1]))
        uc_y = int(rng.integers(unit_cell_y_range[0], unit_cell_y_range[1]))
        uc_z = int(rng.integers(unit_cell_z_range[0], unit_cell_z_range[1]))
        pos = _bcc_positions(uc_x, uc_y, uc_z)
        n = pos.shape[0]
        node_type = rng.integers(0, number_types, size=(n, 1)).astype(np.float64)

        if linear_only:
            out1 = node_type.copy()
        else:
            out1 = _knn_average(pos, node_type, number_neighbors)
        out2 = out1**2 + node_type
        out3 = out1**3
        total = out1.sum() + (0.0 if linear_only else out2.sum() + out3.sum())

        node_table = np.concatenate([node_type, out1, out2, out3], axis=1)
        graph_table = np.array([total], np.float64)

        senders, receivers, shifts = radius_graph(
            pos, radius=radius, max_neighbours=max_neighbours
        )
        s = GraphSample(
            x=node_type,
            pos=pos,
            senders=senders,
            receivers=receivers,
            edge_shifts=shifts,
            extras={"node_table": node_table, "graph_table": graph_table},
        )
        samples.append(s)
    return samples
