"""AtomEye CFG format reader (reference ``hydragnn/preprocess/
cfg_raw_dataset_loader.py`` via ``ase.io.read_cfg``; ASE-free implementation).
Counterpart of ``hydragnn_tpu/datasets/cfg.py``.

Supports the extended CFG layout:
    Number of particles = N
    A = <alat> Angstrom ...
    H0(i,j) = <cell component>
    [.NO_VELOCITY.]
    [entry_count = ...]
    then per-species blocks:  mass line / symbol line / "x y z [aux...]" rows
    (fractional coordinates), or legacy rows "mass symbol x y z ...".

Like the reference, a sibling ``*.bulk`` file (if present) supplies the
graph-level target (bulk modulus, ``cfg_raw_dataset_loader``'s FIXME path).
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..graphs.graph import GraphSample
from .xyz import _Z


def read_cfg_file(path: str) -> GraphSample:
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()]

    n = None
    alat = 1.0
    H = np.eye(3)
    body_start = 0
    for i, ln in enumerate(lines):
        if ln.lower().startswith("number of particles"):
            n = int(ln.split("=")[1])
        elif ln.startswith("A ") or ln.startswith("A="):
            alat = float(re.findall(r"[-\d.eE+]+", ln.split("=")[1])[0])
        elif ln.startswith("H0("):
            m = re.match(r"H0\((\d),(\d)\)\s*=\s*([-\d.eE+]+)", ln)
            if m:
                H[int(m.group(1)) - 1, int(m.group(2)) - 1] = float(m.group(3))
        elif ln and not ln.startswith((".", "#")) and "=" not in ln and i > 0:
            body_start = i
            break
    if n is None:
        raise ValueError(f"{path}: missing 'Number of particles'")

    cell = H * alat
    zs, frac = [], []
    cur_z = 0
    i = body_start
    while i < len(lines) and len(zs) < n:
        ln = lines[i]
        i += 1
        if not ln or ln.startswith("#"):
            continue
        parts = ln.split()
        if len(parts) == 1:
            if parts[0] in _Z:  # species symbol line
                cur_z = _Z[parts[0]]
            # else: mass line — skip
            continue
        if parts[0] in _Z:  # legacy "symbol x y z" rows
            cur_z = _Z[parts[0]]
            coords = [float(v) for v in parts[1:4]]
        elif len(parts) >= 5 and parts[1] in _Z:  # "mass symbol x y z"
            cur_z = _Z[parts[1]]
            coords = [float(v) for v in parts[2:5]]
        else:
            coords = [float(v) for v in parts[:3]]
        zs.append(cur_z)
        frac.append(coords)

    frac = np.asarray(frac, np.float64)
    pos = frac @ cell
    z = np.asarray(zs, np.float64).reshape(-1, 1)

    graph_target = 0.0
    bulk = os.path.splitext(path)[0] + ".bulk"
    if os.path.exists(bulk):
        with open(bulk) as f:
            graph_target = float(f.read().split()[0])

    return GraphSample(
        x=z,
        pos=pos,
        cell=cell,
        pbc=np.array([True, True, True]),
        extras={
            "node_table": z,
            "graph_table": np.array([graph_target], np.float64),
        },
    )


def load_cfg_dir(path: str) -> list[GraphSample]:
    samples = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".cfg"):
            samples.append(read_cfg_file(os.path.join(path, name)))
    if not samples:
        raise FileNotFoundError(f"no .cfg files under {path}")
    return samples
