"""Molecular graph perception without rdkit — the role of the reference's
``hydragnn/utils/descriptors_and_embeddings/xyz2mol.py`` (Kim & Jensen
xyz2mol: covalent-radius connectivity + valence-table bond-order assignment +
octet formal charges) and ``smiles_utils.py`` (SMILES → graph features).

Counterpart of ``hydragnn_tpu/preprocess/molgraph.py``. Pure numpy +
stdlib, so the capability needs no rdkit:

* ``perceive_connectivity(z, pos)`` — adjacency from covalent radii × 1.3
  (reference ``get_AC``, xyz2mol.py:180-218);
* ``assign_bond_orders(z, ac)`` — integer bond orders saturating each atom
  toward its valence-table target by constraint propagation (reference
  ``AC2BO``'s DU-matching, xyz2mol.py:462-529), then per-atom formal
  charges by the reference's ``get_atomic_charge`` rules (:232-252);
* ``xyz2mol(atoms, coordinates)`` — the two combined into a light ``Mol``;
* ``parse_smiles(s)`` — minimal SMILES reader (organic + bracket atoms,
  branches, ring closures incl. %nn, -/=/#/: bonds, aromatic lowercase with
  matching-based kekulization, implicit hydrogens);
* ``smiles_to_graphsample`` / ``mol_to_graphsample`` — GraphSample with
  [Z, n_implicit_H, aromatic, formal_charge] node features and bond-order
  edge features (what the reference's smiles_utils feeds dftb-style
  models, smiles_utils.py:60-132).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# covalent radii in Angstrom (Cordero et al. 2008 values, as rdkit's periodic
# table serves the reference's get_AC)
COVALENT_RADII = {
    1: 0.31, 2: 0.28, 3: 1.28, 4: 0.96, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66,
    9: 0.57, 10: 0.58, 11: 1.66, 12: 1.41, 13: 1.21, 14: 1.11, 15: 1.07,
    16: 1.05, 17: 1.02, 18: 1.06, 19: 2.03, 20: 1.76, 26: 1.32, 29: 1.32,
    30: 1.22, 32: 1.20, 33: 1.19, 34: 1.20, 35: 1.20, 50: 1.39, 53: 1.39,
}

# candidate valences per element (reference atomic_valence, xyz2mol.py:134-147)
ATOMIC_VALENCE = {
    1: [1], 5: [3, 4], 6: [4], 7: [3, 4], 8: [2, 1, 3], 9: [1], 14: [4],
    15: [5, 3], 16: [6, 3, 2], 17: [1], 32: [4], 35: [1], 53: [1],
}

# valence electrons (reference atomic_valence_electrons, :149-162)
VALENCE_ELECTRONS = {
    1: 1, 5: 3, 6: 4, 7: 5, 8: 6, 9: 7, 14: 4, 15: 5, 16: 6, 17: 7,
    32: 4, 35: 7, 53: 7,
}

_SYMBOLS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Fe": 26, "Cu": 29,
    "Zn": 30, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Sn": 50, "I": 53,
}
_NUM_TO_SYMBOL = {v: k for k, v in _SYMBOLS.items()}


def atom_number(atom) -> int:
    """Accept symbols or atomic numbers (reference int_atom, :174-180)."""
    if isinstance(atom, str):
        return _SYMBOLS[atom.capitalize() if len(atom) > 1 else atom.upper()]
    return int(atom)


@dataclass
class Mol:
    """Light molecule record: what xyz2mol's rdkit molobj carries that the
    framework consumes (atoms, 3D coords, integer-order bonds, charges)."""

    atomic_numbers: np.ndarray          # [n] int
    positions: np.ndarray | None        # [n, 3] float or None (from SMILES)
    bonds: list                         # [(i, j, order)]
    formal_charges: np.ndarray          # [n] int
    aromatic: np.ndarray | None = None  # [n] bool (SMILES route only)
    n_hydrogens: np.ndarray | None = None  # [n] implicit H (SMILES route)
    extras: dict = field(default_factory=dict)


def perceive_connectivity(
    z: np.ndarray, pos: np.ndarray, covalent_factor: float = 1.3
) -> np.ndarray:
    """Adjacency matrix: bonded iff dist <= (Rcov_i + Rcov_j) * factor
    (reference ``get_AC``, xyz2mol.py:180-218 — same 1.3 factor)."""
    z = np.asarray([atom_number(a) for a in np.atleast_1d(z)])
    pos = np.asarray(pos, np.float64).reshape(len(z), 3)
    r = np.array([COVALENT_RADII.get(int(a), 1.5) for a in z]) * covalent_factor
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    ac = (d <= (r[:, None] + r[None, :])).astype(np.int64)
    np.fill_diagonal(ac, 0)
    return ac


def _formal_charge(z: int, bo_sum: int) -> int:
    """Reference ``get_atomic_charge`` rules (xyz2mol.py:232-252)."""
    if z == 1:
        return 1 - bo_sum
    if z == 5:
        return 3 - bo_sum
    if z == 15 and bo_sum == 5:
        return 0
    if z == 16 and bo_sum == 6:
        return 0
    return VALENCE_ELECTRONS.get(z, 4) - 8 + bo_sum


def assign_bond_orders(
    z: np.ndarray, ac: np.ndarray, charge: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Integer bond-order matrix + per-atom formal charges.

    The reference's AC2BO enumerates valence combinations and matches
    degree-of-unsaturation (DU) pairs; here the same saturation is reached by
    constraint propagation: every atom gets the smallest table valence that
    fits its degree, then bonded pairs with remaining unsaturation raise
    their bond order — most-constrained pair first (fewest unsaturated
    neighbors), which resolves conjugated rings the way DU matching does."""
    z = np.asarray([atom_number(a) for a in np.atleast_1d(z)])
    n = len(z)
    ac = np.asarray(ac, np.int64)
    degree = ac.sum(axis=1)
    # candidate valences in the table's PREFERENCE order (the reference's
    # itertools.product tries combinations in exactly this order and keeps
    # the first saturable one), filtered to >= degree
    cand_lists = []
    for i in range(n):
        cands = ATOMIC_VALENCE.get(int(z[i]), [int(degree[i])])
        fits = [v for v in cands if v >= degree[i]]
        cand_lists.append(fits or [max(cands)])
    choice = [0] * n

    def saturate(target: np.ndarray) -> np.ndarray:
        bo = ac.copy()

        while True:
            d = np.maximum(target - bo.sum(axis=1), 0)
            cand = [
                (i, j)
                for i in range(n)
                for j in range(i + 1, n)
                if bo[i, j] > 0 and d[i] > 0 and d[j] > 0
            ]
            if not cand:
                return bo
            # most-constrained pair first: fewest unsaturated bonded
            # partners — resolves conjugation the way DU matching does
            def freedom(pair):
                i, j = pair
                fi = sum(1 for k in range(n) if bo[i, k] > 0 and d[k] > 0)
                fj = sum(1 for k in range(n) if bo[j, k] > 0 and d[k] > 0)
                return (min(fi, fj), fi + fj)

            i, j = min(cand, key=freedom)
            bo[i, j] += 1
            bo[j, i] += 1

    # advance unsaturable atoms (or, failing that, a bonded neighbor of one)
    # to their next preference valence until the assignment settles, keeping
    # the best-scoring candidate seen — the reference's first-valid-
    # combination search over itertools.product, reached by local repair.
    # Score: total leftover unsaturation, then distance of the charge sum
    # from the requested total charge (the reference AC2BO's charge check),
    # then total |formal charge|.
    def charges_of(bo):
        return np.array(
            [_formal_charge(int(z[i]), int(bo[i].sum())) for i in range(n)],
            np.int64,
        )

    best = None
    for _ in range(sum(len(c) for c in cand_lists) + 1):
        target = np.array(
            [cand_lists[i][choice[i]] for i in range(n)], np.int64
        )
        bo = saturate(target)
        leftover = np.maximum(target - bo.sum(axis=1), 0)
        q = charges_of(bo)
        score = (int(leftover.sum()), abs(int(q.sum()) - int(charge)),
                 int(np.abs(q).sum()))
        if best is None or score < best[0]:
            best = (score, bo, q)
        if leftover.sum() == 0 and int(q.sum()) == int(charge):
            break
        movable = [
            i for i in range(n)
            if leftover[i] > 0 and choice[i] + 1 < len(cand_lists[i])
        ]
        if not movable:
            # advance a neighbor of a stuck atom instead (CO: O 2 -> 3
            # unlocks the triple bond)
            stuck = np.flatnonzero(leftover > 0)
            movable = [
                j
                for i in stuck
                for j in range(n)
                if ac[i, j] and choice[j] + 1 < len(cand_lists[j])
            ]
        if not movable:
            break
        choice[movable[0]] += 1

    _, bo, charges = best
    return bo, charges


def xyz2mol(atoms, coordinates, charge: int = 0,
            covalent_factor: float = 1.3) -> Mol:
    """Coordinates -> molecule with perceived bonds (reference xyz2mol entry,
    xyz2mol.py:730-785, minus rdkit canonicalization)."""
    z = np.asarray([atom_number(a) for a in np.atleast_1d(atoms)])
    pos = np.asarray(coordinates, np.float64).reshape(len(z), 3)
    ac = perceive_connectivity(z, pos, covalent_factor)
    bo, charges = assign_bond_orders(z, ac, charge)
    bonds = [
        (i, j, int(bo[i, j]))
        for i in range(len(z))
        for j in range(i + 1, len(z))
        if bo[i, j] > 0
    ]
    return Mol(z, pos, bonds, charges)


# -- SMILES ----------------------------------------------------------------

_ORGANIC = ("Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I")
_AROMATIC = {"b": 5, "c": 6, "n": 7, "o": 8, "p": 15, "s": 16}
_BOND_ORDER = {"-": 1, "=": 2, "#": 3, ":": 1, "/": 1, "\\": 1}
_DEFAULT_VALENCE = {5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 15: 3, 16: 2, 17: 1,
                    35: 1, 53: 1}


def _charged_valence(z: int, q: int) -> int:
    """Bonding capacity of a charged atom. For N/P/O/S the charge shifts the
    valence by q in BOTH directions ([NH4+]: 4, [NH2-]: 2, [OH3+]: 3,
    [OH-]: 1); for other elements a charge costs a bond either way
    ([CH3+]/[CH3-]: 3)."""
    base = _DEFAULT_VALENCE.get(z, 4)
    if z in (7, 15, 8, 16):
        return base + q
    return base - abs(q)


def parse_smiles(s: str) -> Mol:
    """Minimal SMILES reader: organic-subset + bracket atoms, branches, ring
    closures (digits and %nn), -/=/#/: bonds, aromatic lowercase. Aromatic
    systems are kekulized by greedy maximum matching over atoms that need one
    more bond, then implicit hydrogens fill to the default valence — the
    subset the reference's smiles_utils consumes for its datasets."""
    atoms: list[dict] = []
    bonds: list[list[int]] = []
    stack: list[int] = []
    ring: dict[str, tuple[int, int]] = {}
    prev = -1
    order = 0  # 0 = unspecified
    i = 0
    while i < len(s):
        ch = s[i]
        if ch in "()":
            if ch == "(":
                stack.append(prev)
            else:
                prev = stack.pop()
            i += 1
            continue
        if ch in _BOND_ORDER:
            order = _BOND_ORDER[ch]
            i += 1
            continue
        if ch == ".":
            prev = -1
            order = 0
            i += 1
            continue
        if ch.isdigit() or ch == "%":
            if ch == "%":
                key, i = s[i + 1 : i + 3], i + 3
            else:
                key, i = ch, i + 1
            if key in ring:
                j, o = ring.pop(key)
                bonds.append([j, prev, max(order, o, 0)])
            else:
                ring[key] = (prev, order)
            order = 0
            continue
        if ch == "[":
            end = s.index("]", i)
            body = s[i + 1 : end]
            i = end + 1
            idx = _parse_bracket_atom(body, atoms)
        else:
            matched = next((t for t in _ORGANIC if s.startswith(t, i)), None)
            if matched:
                atoms.append({"z": _SYMBOLS[matched], "arom": False,
                              "h": None, "q": 0})
                idx = len(atoms) - 1
                i += len(matched)
            elif ch in _AROMATIC:
                atoms.append({"z": _AROMATIC[ch], "arom": True,
                              "h": None, "q": 0})
                idx = len(atoms) - 1
                i += 1
            else:
                raise ValueError(f"unsupported SMILES token {ch!r} in {s!r}")
        if prev >= 0:
            bonds.append([prev, idx, order])
        prev = idx
        order = 0

    if ring:
        raise ValueError(f"unclosed ring bonds {sorted(ring)} in {s!r}")
    return _finalize_smiles_mol(atoms, bonds)


def _parse_bracket_atom(body: str, atoms: list) -> int:
    import re

    m = re.fullmatch(
        r"(?P<iso>\d+)?(?P<sym>[A-Za-z][a-z]?)(?P<hy>H\d?)?"
        r"(?P<chg>[+-]+\d?|\+\d+|-\d+)?",
        body.replace("@", ""),
    )
    if not m:
        raise ValueError(f"unsupported bracket atom [{body}]")
    sym = m.group("sym")
    arom = sym[0].islower()
    if arom:
        if sym not in _AROMATIC:
            raise ValueError(f"unsupported aromatic atom [{body}]")
        z = _AROMATIC[sym]
    else:
        key = sym.capitalize() if len(sym) > 1 else sym
        if key not in _SYMBOLS:
            raise ValueError(f"unsupported element in bracket atom [{body}]")
        z = _SYMBOLS[key]
    h = 0
    if m.group("hy"):
        h = int(m.group("hy")[1:] or 1)
    q = 0
    if m.group("chg"):
        c = m.group("chg")
        if len(c) > 1 and c[1:].isdigit():
            q = int(c[1:]) * (1 if c[0] == "+" else -1)  # [Fe+2] / [O-2]
        else:
            q = c.count("+") - c.count("-")  # [O-] / [Cu++]
    atoms.append({"z": z, "arom": arom, "h": h, "q": q})
    return len(atoms) - 1


def _finalize_smiles_mol(atoms: list[dict], bonds: list[list[int]]) -> Mol:
    n = len(atoms)
    z = np.array([a["z"] for a in atoms], np.int64)
    arom = np.array([a["arom"] for a in atoms], bool)
    # default unspecified bond order: 1 (aromatic pairs get matched below)
    bo = {}
    adj: list[list[int]] = [[] for _ in range(n)]
    for a, b, o in bonds:
        bo[(min(a, b), max(a, b))] = max(o, 1)
        adj[a].append(b)
        adj[b].append(a)

    # kekulize: aromatic atoms that still need a bond (explicit valence +
    # declared H < default valence) pair up along aromatic-aromatic bonds —
    # greedy augmenting-path matching (rings are small)
    def needs_pi(i: int) -> bool:
        if not arom[i]:
            return False
        zi = int(z[i])
        declared_h = atoms[i]["h"]
        val = sum(
            bo[(min(i, j), max(i, j))] for j in adj[i]
        ) + (declared_h or 0)
        target = _charged_valence(zi, atoms[i]["q"])
        # pyridine-type N (no declared H) ends below target and takes the pi
        # bond; pyrrole-type [nH]'s declared H fills the valence via ``val``
        return val < target

    match: dict[int, int] = {}

    def try_augment(i: int, seen: set) -> bool:
        for j in adj[i]:
            if not arom[j] or not needs_pi(j) or (min(i, j), max(i, j)) not in bo:
                continue
            if j in seen:
                continue
            seen.add(j)
            if j not in match or try_augment(match[j], seen):
                match[i] = j
                match[j] = i
                return True
        return False

    for i in range(n):
        if arom[i] and needs_pi(i) and i not in match:
            try_augment(i, {i})
    for i, j in list(match.items()):
        if i < j:
            bo[(i, j)] = 2

    # implicit hydrogens + formal charges
    n_h = np.zeros(n, np.int64)
    q = np.array([a["q"] for a in atoms], np.int64)
    for i in range(n):
        if atoms[i]["h"] is not None:
            n_h[i] = atoms[i]["h"]
            continue
        val = sum(bo[(min(i, j), max(i, j))] for j in adj[i])
        n_h[i] = max(_charged_valence(int(z[i]), int(q[i])) - val, 0)
    bond_list = [(a, b, o) for (a, b), o in sorted(bo.items())]
    return Mol(z, None, bond_list, q, aromatic=arom, n_hydrogens=n_h)


# -- GraphSample conversion -------------------------------------------------

def mol_to_graphsample(mol: Mol):
    """Mol -> GraphSample: nodes [Z, n_H, aromatic, formal_charge], directed
    edges both ways with bond order as edge_attr (the reference
    smiles_utils.generate_graphdata feature layout)."""
    from ..graphs.graph import GraphSample

    n = len(mol.atomic_numbers)
    n_h = mol.n_hydrogens if mol.n_hydrogens is not None else np.zeros(n)
    arom = mol.aromatic if mol.aromatic is not None else np.zeros(n, bool)
    x = np.stack(
        [
            np.asarray(mol.atomic_numbers, np.float32),
            np.asarray(n_h, np.float32),
            np.asarray(arom, np.float32),
            np.asarray(mol.formal_charges, np.float32),
        ],
        axis=1,
    )
    snd, rcv, attr = [], [], []
    for i, j, o in mol.bonds:
        snd += [i, j]
        rcv += [j, i]
        attr += [o, o]
    return GraphSample(
        x=x,
        pos=(
            np.asarray(mol.positions, np.float32)
            if mol.positions is not None
            else np.zeros((n, 3), np.float32)
        ),
        senders=np.asarray(snd, np.int32),
        receivers=np.asarray(rcv, np.int32),
        edge_attr=np.asarray(attr, np.float32).reshape(-1, 1),
    )


def smiles_to_graphsample(smiles: str):
    return mol_to_graphsample(parse_smiles(smiles))


__all__ = [
    "Mol", "perceive_connectivity", "assign_bond_orders", "xyz2mol",
    "parse_smiles", "smiles_to_graphsample", "mol_to_graphsample",
]
