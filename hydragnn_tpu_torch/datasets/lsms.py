"""LSMS raw text format reader/writer.

Counterpart of ``hydragnn_tpu/datasets/lsms.py``: the same samples, field
by field.

Reference: ``hydragnn/preprocess/lsms_raw_dataset_loader.py:26-106`` and the
test fixture writer ``tests/deterministic_graph_data.py:80-173``. Format:

    GRAPH_OUTPUT[S...]
    FEAT  INDEX  X  Y  Z  OUT1  OUT2  OUT3 ...
    ...

The reader builds full feature tables (``extras['node_table']`` /
``graph_table``) so ``apply_variables_of_interest`` can column-select inputs
and targets; the optional LSMS charge-density correction (``x[:,1] -= x[:,0]``,
reference ``:90-106``) applies when two leading node features are present.
"""

from __future__ import annotations

import os

import numpy as np

from ..graphs.graph import GraphSample


def write_lsms_file(path: str, graph_feats, node_table, positions) -> None:
    """Write one LSMS sample: graph features line + per-node rows
    [feat, index, x, y, z, outputs...]."""
    with open(path, "w") as f:
        f.write("\t".join(str(float(v)) for v in np.atleast_1d(graph_feats)))
        node_table = np.asarray(node_table)
        positions = np.asarray(positions)
        for i in range(node_table.shape[0]):
            feat = node_table[i, 0]
            outputs = node_table[i, 1:]
            row = [feat, float(i), *positions[i], *outputs]
            f.write("\n" + "\t".join(f"{float(v):.8g}" for v in row))


def read_lsms_file(path: str, charge_density_update: bool = False) -> GraphSample:
    with open(path, encoding="utf-8") as f:
        lines = f.readlines()
    graph_feats = np.array([float(v) for v in lines[0].split()], np.float64)
    rows = [np.array([float(v) for v in ln.split()], np.float64) for ln in lines[1:] if ln.strip()]
    table = np.stack(rows)
    pos = table[:, 2:5]
    feat_cols = np.concatenate([table[:, :1], table[:, 5:]], axis=1)
    if charge_density_update and feat_cols.shape[1] >= 2:
        feat_cols[:, 1] -= feat_cols[:, 0]
    return GraphSample(
        x=feat_cols[:, :1],
        pos=pos,
        extras={"node_table": feat_cols, "graph_table": graph_feats},
    )


def load_lsms_dir(path: str, charge_density_update: bool = False) -> list[GraphSample]:
    samples = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".txt"):
            samples.append(
                read_lsms_file(os.path.join(path, name), charge_density_update)
            )
    if not samples:
        raise FileNotFoundError(f"no LSMS .txt files under {path}")
    return samples
