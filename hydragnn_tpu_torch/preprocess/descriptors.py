"""Atomic descriptors + molecule-graph utilities (rdkit/mendeleev-free).

Parity target: ``hydragnn/utils/descriptors_and_embeddings/``:

* ``atomicdescriptors`` builds per-element embeddings from the ``mendeleev``
  database (one-hot type id, group, period, covalent radius, electron
  affinity, block, atomic volume, Z, mass, electronegativity, valence
  electrons, first ionization energy) and caches them as JSON keyed by Z.
  Here the same feature set comes from a built-in table of standard physical
  constants (approximate published values — descriptors, not observables), so
  no external database is needed.
* ``xyz2mol.py`` / ``smiles_utils.py`` need rdkit for bond perception /
  SMILES parsing; here ``molgraph.py`` does both in numpy.

Counterpart of ``hydragnn_tpu/preprocess/descriptors.py``.
"""

from __future__ import annotations

import json
import os

import numpy as np

# Z: (symbol, group, period, block, mass, electronegativity (Pauling),
#     covalent_radius_pm, electron_affinity_eV, atomic_volume_cm3_mol,
#     valence_electrons, first_ionization_eV)
# Standard published values (rounded); descriptors, not physical observables.
_ELEMENTS: dict[int, tuple] = {
    1:  ("H",  1,  1, "s", 1.008,   2.20,  31, 0.754, 14.1, 1, 13.598),
    2:  ("He", 18, 1, "s", 4.0026,  0.0,   28, 0.0,   31.8, 2, 24.587),
    3:  ("Li", 1,  2, "s", 6.94,    0.98, 128, 0.618, 13.1, 1, 5.392),
    4:  ("Be", 2,  2, "s", 9.0122,  1.57,  96, 0.0,    5.0, 2, 9.323),
    5:  ("B",  13, 2, "p", 10.81,   2.04,  84, 0.277,  4.6, 3, 8.298),
    6:  ("C",  14, 2, "p", 12.011,  2.55,  76, 1.263,  5.3, 4, 11.260),
    7:  ("N",  15, 2, "p", 14.007,  3.04,  71, 0.0,   17.3, 5, 14.534),
    8:  ("O",  16, 2, "p", 15.999,  3.44,  66, 1.461, 14.0, 6, 13.618),
    9:  ("F",  17, 2, "p", 18.998,  3.98,  57, 3.401, 17.1, 7, 17.423),
    10: ("Ne", 18, 2, "p", 20.180,  0.0,   58, 0.0,   16.8, 8, 21.565),
    11: ("Na", 1,  3, "s", 22.990,  0.93, 166, 0.548, 23.7, 1, 5.139),
    12: ("Mg", 2,  3, "s", 24.305,  1.31, 141, 0.0,   14.0, 2, 7.646),
    13: ("Al", 13, 3, "p", 26.982,  1.61, 121, 0.441, 10.0, 3, 5.986),
    14: ("Si", 14, 3, "p", 28.085,  1.90, 111, 1.385, 12.1, 4, 8.152),
    15: ("P",  15, 3, "p", 30.974,  2.19, 107, 0.746, 17.0, 5, 10.487),
    16: ("S",  16, 3, "p", 32.06,   2.58, 105, 2.077, 15.5, 6, 10.360),
    17: ("Cl", 17, 3, "p", 35.45,   3.16, 102, 3.613, 17.4, 7, 12.968),
    18: ("Ar", 18, 3, "p", 39.948,  0.0,  106, 0.0,   24.2, 8, 15.760),
    19: ("K",  1,  4, "s", 39.098,  0.82, 203, 0.501, 45.4, 1, 4.341),
    20: ("Ca", 2,  4, "s", 40.078,  1.00, 176, 0.025, 26.2, 2, 6.113),
    21: ("Sc", 3,  4, "d", 44.956,  1.36, 170, 0.188, 15.0, 3, 6.561),
    22: ("Ti", 4,  4, "d", 47.867,  1.54, 160, 0.079, 10.6, 4, 6.828),
    23: ("V",  5,  4, "d", 50.942,  1.63, 153, 0.525,  8.3, 5, 6.746),
    24: ("Cr", 6,  4, "d", 51.996,  1.66, 139, 0.666,  7.2, 6, 6.767),
    25: ("Mn", 7,  4, "d", 54.938,  1.55, 139, 0.0,    7.4, 7, 7.434),
    26: ("Fe", 8,  4, "d", 55.845,  1.83, 132, 0.151,  7.1, 8, 7.902),
    27: ("Co", 9,  4, "d", 58.933,  1.88, 126, 0.662,  6.7, 9, 7.881),
    28: ("Ni", 10, 4, "d", 58.693,  1.91, 124, 1.156,  6.6, 10, 7.640),
    29: ("Cu", 11, 4, "d", 63.546,  1.90, 132, 1.235,  7.1, 11, 7.726),
    30: ("Zn", 12, 4, "d", 65.38,   1.65, 122, 0.0,    9.2, 12, 9.394),
    31: ("Ga", 13, 4, "p", 69.723,  1.81, 122, 0.43,  11.8, 3, 5.999),
    32: ("Ge", 14, 4, "p", 72.630,  2.01, 120, 1.233, 13.6, 4, 7.900),
    33: ("As", 15, 4, "p", 74.922,  2.18, 119, 0.804, 13.1, 5, 9.815),
    34: ("Se", 16, 4, "p", 78.971,  2.55, 120, 2.021, 16.5, 6, 9.752),
    35: ("Br", 17, 4, "p", 79.904,  2.96, 120, 3.364, 23.5, 7, 11.814),
    36: ("Kr", 18, 4, "p", 83.798,  3.00, 116, 0.0,   32.2, 8, 14.000),
    37: ("Rb", 1,  5, "s", 85.468,  0.82, 220, 0.486, 55.9, 1, 4.177),
    38: ("Sr", 2,  5, "s", 87.62,   0.95, 195, 0.048, 33.7, 2, 5.695),
    39: ("Y",  3,  5, "d", 88.906,  1.22, 190, 0.307, 19.8, 3, 6.217),
    40: ("Zr", 4,  5, "d", 91.224,  1.33, 175, 0.426, 14.1, 4, 6.634),
    41: ("Nb", 5,  5, "d", 92.906,  1.60, 164, 0.893, 10.8, 5, 6.759),
    42: ("Mo", 6,  5, "d", 95.95,   2.16, 154, 0.748,  9.4, 6, 7.092),
    43: ("Tc", 7,  5, "d", 98.0,    1.90, 147, 0.55,   8.5, 7, 7.280),
    44: ("Ru", 8,  5, "d", 101.07,  2.20, 146, 1.05,   8.3, 8, 7.360),
    45: ("Rh", 9,  5, "d", 102.91,  2.28, 142, 1.137,  8.3, 9, 7.459),
    46: ("Pd", 10, 5, "d", 106.42,  2.20, 139, 0.562,  8.9, 10, 8.337),
    47: ("Ag", 11, 5, "d", 107.87,  1.93, 145, 1.302, 10.3, 11, 7.576),
    48: ("Cd", 12, 5, "d", 112.41,  1.69, 144, 0.0,   13.1, 12, 8.994),
    49: ("In", 13, 5, "p", 114.82,  1.78, 142, 0.3,   15.7, 3, 5.786),
    50: ("Sn", 14, 5, "p", 118.71,  1.96, 139, 1.112, 16.3, 4, 7.344),
    51: ("Sb", 15, 5, "p", 121.76,  2.05, 139, 1.046, 18.2, 5, 8.608),
    52: ("Te", 16, 5, "p", 127.60,  2.10, 138, 1.971, 20.5, 6, 9.010),
    53: ("I",  17, 5, "p", 126.90,  2.66, 139, 3.059, 25.7, 7, 10.451),
    54: ("Xe", 18, 5, "p", 131.29,  2.60, 140, 0.0,   42.9, 8, 12.130),
    55: ("Cs", 1,  6, "s", 132.91,  0.79, 244, 0.472, 70.0, 1, 3.894),
    56: ("Ba", 2,  6, "s", 137.33,  0.89, 215, 0.145, 39.0, 2, 5.212),
    74: ("W",  6,  6, "d", 183.84,  2.36, 162, 0.815,  9.5, 6, 7.864),
    77: ("Ir", 9,  6, "d", 192.22,  2.20, 141, 1.564,  8.5, 9, 8.967),
    78: ("Pt", 10, 6, "d", 195.08,  2.28, 136, 2.128,  9.1, 10, 8.959),
    79: ("Au", 11, 6, "d", 196.97,  2.54, 136, 2.309, 10.2, 11, 9.226),
    80: ("Hg", 12, 6, "d", 200.59,  2.00, 132, 0.0,   14.8, 12, 10.438),
    82: ("Pb", 14, 6, "p", 207.2,   2.33, 146, 0.356, 18.3, 4, 7.417),
    83: ("Bi", 15, 6, "p", 208.98,  2.02, 148, 0.942, 21.3, 5, 7.286),
}

_SYMBOL_TO_Z = {v[0]: z for z, v in _ELEMENTS.items()}
_BLOCKS = ("s", "p", "d", "f")


def _bin_onehot(values: np.ndarray, num_classes: int = 10) -> np.ndarray:
    """Equal-width binning of a real property into one-hot classes (the
    reference's ``convert_realproperty_onehot``)."""
    lo, hi = float(values.min()), float(values.max())
    span = (hi - lo) or 1.0
    bins = np.clip(((values - lo) / span * num_classes).astype(int), 0, num_classes - 1)
    out = np.zeros((len(values), num_classes), np.float32)
    out[np.arange(len(values)), bins] = 1.0
    return out


def _int_onehot(values: np.ndarray) -> np.ndarray:
    width = int(values.max()) + 1
    out = np.zeros((len(values), width), np.float32)
    out[np.arange(len(values)), values.astype(int)] = 1.0
    return out


class AtomicDescriptors:
    """Per-element embedding table (``atomicdescriptors`` equivalent).

    ``atom_embeddings`` maps ``str(Z) -> list[float]``, same keying as the
    reference's JSON cache so downstream code is interchangeable.
    """

    def __init__(
        self,
        embeddingfilename: str | None = None,
        overwritten: bool = True,
        element_types: list[str] | None = ("C", "H", "O", "N", "F", "S"),
        one_hot: bool = False,
    ):
        if (
            embeddingfilename
            and os.path.exists(embeddingfilename)
            and not overwritten
        ):
            with open(embeddingfilename) as f:
                self.atom_embeddings = json.load(f)
            self.element_types = None
            return

        if element_types is None:
            zs = sorted(_ELEMENTS)
        else:
            missing = [s for s in element_types if s not in _SYMBOL_TO_Z]
            if missing:
                raise ValueError(
                    f"elements {missing} not in the built-in table "
                    f"(available: {sorted(_SYMBOL_TO_Z)})"
                )
            zs = sorted(_SYMBOL_TO_Z[s] for s in element_types)
        self.element_types = [_ELEMENTS[z][0] for z in zs]

        rows = np.array(
            [
                (
                    _ELEMENTS[z][1],  # group
                    _ELEMENTS[z][2],  # period
                    _ELEMENTS[z][6],  # covalent radius
                    _ELEMENTS[z][7],  # electron affinity
                    _BLOCKS.index(_ELEMENTS[z][3]),  # block id
                    _ELEMENTS[z][8],  # atomic volume
                    z,  # atomic number
                    _ELEMENTS[z][4],  # mass
                    _ELEMENTS[z][5],  # electronegativity
                    _ELEMENTS[z][9],  # valence electrons
                    _ELEMENTS[z][10],  # first ionization energy
                )
                for z in zs
            ],
            np.float64,
        )
        type_id = np.eye(len(zs), dtype=np.float32)
        block_oh = _int_onehot(rows[:, 4])
        if one_hot:
            cols = [
                type_id,
                _int_onehot(rows[:, 0] - 1),  # group
                _int_onehot(rows[:, 1] - 1),  # period
                _bin_onehot(rows[:, 2]),  # covalent radius
                _bin_onehot(rows[:, 3]),  # electron affinity
                block_oh,
                _bin_onehot(rows[:, 5]),  # atomic volume
                _int_onehot(rows[:, 6] - 1),  # Z
                _bin_onehot(rows[:, 7]),  # mass
                _bin_onehot(rows[:, 8]),  # electronegativity
                _int_onehot(rows[:, 9] - 1),  # valence electrons
                _bin_onehot(rows[:, 10]),  # ionization energy
            ]
        else:
            cols = [
                type_id,
                rows[:, 0:1],
                rows[:, 1:2],
                rows[:, 2:3],
                rows[:, 3:4],
                block_oh,
                rows[:, 5:6],
                rows[:, 6:7],
                rows[:, 7:8],
                rows[:, 8:9],
                rows[:, 9:10],
                rows[:, 10:11],
            ]
        table = np.concatenate([np.asarray(c, np.float32) for c in cols], axis=1)
        self.atom_embeddings = {
            str(z): table[i].tolist() for i, z in enumerate(zs)
        }
        if embeddingfilename:
            with open(embeddingfilename, "w") as f:
                json.dump(self.atom_embeddings, f)

    def get_atom_features(self, atomic_number: int) -> list[float]:
        key = str(int(atomic_number))
        if key not in self.atom_embeddings:
            raise ValueError(f"element Z={atomic_number} not in descriptor table")
        return self.atom_embeddings[key]


def attach_atomic_descriptors(sample, descriptors: AtomicDescriptors, z_column: int = 0):
    """Append per-atom descriptor features to ``sample.x`` (the reference's
    embedding-concat use of the JSON table)."""
    zs = np.round(np.asarray(sample.x[:, z_column])).astype(int)
    feats = np.array([descriptors.get_atom_features(z) for z in zs], np.float32)
    sample.x = np.concatenate([np.asarray(sample.x, np.float32), feats], axis=1)
    return sample


def xyz2mol(atoms, coordinates, **kwargs):
    """Bond perception from raw coordinates (reference ``xyz2mol.py``'s Kim &
    Jensen algorithm) — numpy-native implementation, no rdkit needed; see
    ``preprocess.molgraph`` for the full API (connectivity, bond orders,
    formal charges, GraphSample conversion)."""
    from .molgraph import xyz2mol as _impl

    return _impl(atoms, coordinates, **kwargs)


def smiles_to_graph(smiles: str, **kwargs):
    """SMILES -> GraphSample (reference ``smiles_utils.py``) — numpy-native
    parser with kekulization + implicit hydrogens (``preprocess.molgraph``);
    node features [Z, n_H, aromatic, formal_charge], bond-order edges."""
    from .molgraph import smiles_to_graphsample

    return smiles_to_graphsample(smiles, **kwargs)
