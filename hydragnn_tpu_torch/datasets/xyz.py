"""(Extended) XYZ format reader (reference ``hydragnn/utils/datasets/
xyzdataset.py`` via ASE; ASE-free implementation).

Counterpart of ``hydragnn_tpu/datasets/xyz.py``: the same samples, field by
field, QM9's raw flavour included (the ``gdb`` comment line with its 15
properties, ``*^`` exponents).

Standard XYZ: line 1 = atom count, line 2 = comment (optionally extended-xyz
``key=value`` pairs incl. ``energy=...`` and ``Lattice="ax ay az bx ..."``),
then ``SYMBOL x y z [fx fy fz]`` rows. Multiple frames per file supported.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..graphs.graph import GraphSample

_SYMBOLS = (
    "X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co "
    "Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb Te "
    "I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re Os Ir "
    "Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu"
).split()
_Z = {s: i for i, s in enumerate(_SYMBOLS)}


def _parse_comment(comment: str) -> dict:
    out = {}
    for m in re.finditer(r'(\w+)=("([^"]*)"|\S+)', comment):
        key = m.group(1).lower()
        val = m.group(3) if m.group(3) is not None else m.group(2)
        out[key] = val
    return out


def _float(tok: str) -> float:
    """Float parse tolerating QM9's Mathematica exponents (``1.66*^-6``)."""
    return float(tok.replace("*^", "e"))


# QM9 raw xyz property line: 'gdb <id>' then 15 scalars in this order
# (torch_geometric.datasets.QM9 target layout; U0 = internal energy at 0K).
_QM9_PROPS = (
    "A", "B", "C", "mu", "alpha", "homo", "lumo", "gap", "r2",
    "zpve", "U0", "U", "H", "G", "Cv",
)


def _parse_qm9_comment(comment: str) -> dict | None:
    """Detect and parse QM9's raw comment line ('gdb 123\\t<15 values>').
    Returns {prop: value} (+ '_qm9': True) or None if not QM9-shaped."""
    parts = comment.split()
    if len(parts) < 2 + len(_QM9_PROPS) or parts[0] != "gdb":
        return None
    try:
        vals = [_float(t) for t in parts[2 : 2 + len(_QM9_PROPS)]]
    except ValueError:
        return None
    out = dict(zip(_QM9_PROPS, vals))
    out["_qm9"] = True
    return out


def _forces_column(meta: dict) -> int | None:
    """Column index of fx in an extended-xyz Properties= spec, or None."""
    props = meta.get("properties")
    if not props:
        return None
    col = 0
    for name, _kind, width in zip(*[iter(props.split(":"))] * 3):
        w = int(width)
        if name.lower() in ("forces", "force"):
            return col
        col += w
    return None


def read_xyz_file(path: str, limit: int | None = None) -> list[GraphSample]:
    samples = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        if limit is not None and len(samples) >= limit:
            break
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].strip())
        qm9 = _parse_qm9_comment(lines[i + 1])
        meta = _parse_comment(lines[i + 1]) if qm9 is None else {}
        rows = [lines[i + 2 + j].split() for j in range(n)]
        # forces: take the column named in Properties=; else the conventional
        # columns 4:7, but ONLY when every row carries them (a partial or
        # differently-typed tail would silently misassign forces)
        f_col = _forces_column(meta)
        if f_col is None and all(len(r) >= 7 for r in rows):
            f_col = 4
        zs, pos, forces = [], [], []
        for parts in rows:
            zs.append(_Z.get(parts[0], 0) if not parts[0].isdigit() else int(parts[0]))
            pos.append([_float(v) for v in parts[1:4]])
            if f_col is not None and len(parts) >= f_col + 3:
                forces.append([_float(v) for v in parts[f_col : f_col + 3]])
        z = np.asarray(zs, np.float64).reshape(-1, 1)
        cell = pbc = None
        if "lattice" in meta:
            cell = np.array([float(v) for v in meta["lattice"].split()]).reshape(3, 3)
            pbc = np.array([True, True, True])
        if qm9 is not None:
            # QM9 atom rows end with a Mulliken charge column, not forces
            forces = []
            energy = qm9["U0"]
            graph_table = np.array([qm9[p] for p in _QM9_PROPS], np.float64)
        else:
            energy = float(meta["energy"]) if "energy" in meta else 0.0
            graph_table = np.array([energy], np.float64)
        if forces and len(forces) != n:
            forces = []  # inconsistent rows: drop rather than misassign
        s = GraphSample(
            x=z,
            pos=np.asarray(pos),
            energy_y=np.array([energy]),
            forces_y=np.asarray(forces) if forces else None,
            cell=cell,
            pbc=pbc,
            extras={
                "node_table": z,
                "graph_table": graph_table,
            },
        )
        samples.append(s)
        i += 2 + n
        if qm9 is not None:
            # skip QM9 trailing records (frequencies, SMILES, InChI) up to
            # the next frame header (a bare atom-count line) or EOF
            while i < len(lines):
                tok = lines[i].strip()
                if tok and tok.split()[0].isdigit() and len(tok.split()) == 1:
                    break
                i += 1
    return samples


def load_xyz_dir(path: str, limit: int | None = None) -> list[GraphSample]:
    samples = []
    for name in sorted(os.listdir(path)):
        if limit is not None and len(samples) >= limit:
            break
        if name.endswith(".xyz"):
            left = None if limit is None else limit - len(samples)
            samples.extend(read_xyz_file(os.path.join(path, name), limit=left))
    if not samples:
        raise FileNotFoundError(f"no .xyz files under {path}")
    return samples
