"""LSMS materials postprocessing: formation enthalpy / Gibbs energy and
compositional downselection.

Parity targets:
* ``hydragnn/utils/lsms/convert_total_energy_to_formation_gibbs.py`` —
  binary-alloy total energy -> formation enthalpy -> formation Gibbs energy
  (thermodynamic mixing entropy at a given temperature), rewriting the LSMS
  files with the converted target.
* ``hydragnn/utils/lsms/compositional_histogram_cutoff.py`` — cap the number
  of samples per composition bin.

Counterpart of ``hydragnn_tpu/postprocess/lsms.py``.

Numerics note: the mixing-entropy term uses ``lgamma`` for log C(n, k)
instead of the reference's ``log(scipy.special.comb(...))`` — identical
values where the latter is finite, and no float overflow for large cells.
"""

from __future__ import annotations

import math
import os
import shutil

import numpy as np

# LSMS energies are Rydberg; entropy converts Kb into Rydberg/K.
_KB_JOULE_PER_K = 1.380649e-23
_JOULE_TO_RYDBERG = 4.5874208973812e17
KB_RYDBERG_PER_K = _KB_JOULE_PER_K * _JOULE_TO_RYDBERG


def _log_comb(n: int, k: int) -> float:
    return (
        math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
    )


def compute_formation_enthalpy(
    atom_types: np.ndarray,
    total_energy: float,
    elements_list,
    pure_elements_energy: dict,
):
    """Binary-alloy decomposition of a total energy (reference
    ``compute_formation_enthalpy``, ``:143-183``): returns (composition of
    element 1, linear mixing energy, formation enthalpy, mixing entropy)."""
    elements_list = sorted(elements_list)
    types = np.asarray(atom_types).reshape(-1)
    elements, counts = np.unique(types, return_counts=True)
    for e in elements:
        if e not in elements_list:
            raise ValueError(f"sample contains element {e} outside {elements_list}")
    # pure-component fixup: missing element gets count 0
    elements = list(elements)
    counts = list(counts)
    for i, elem in enumerate(elements_list):
        if elem not in elements:
            elements.insert(i, elem)
            counts.insert(i, 0)

    num_atoms = len(types)
    composition = counts[0] / num_atoms
    linear_mixing_energy = (
        pure_elements_energy[elements[0]] * composition
        + pure_elements_energy[elements[1]] * (1 - composition)
    ) * num_atoms
    formation_enthalpy = float(total_energy) - linear_mixing_energy
    entropy = KB_RYDBERG_PER_K * _log_comb(num_atoms, int(counts[0]))
    return composition, linear_mixing_energy, formation_enthalpy, entropy


def _read_lsms(path: str):
    with open(path) as f:
        txt = f.readlines()
    total_energy_txt = txt[0].split()[0]
    atoms = np.loadtxt(txt[1:])
    if atoms.ndim == 1:
        atoms = atoms[None, :]
    return total_energy_txt, atoms, txt


def convert_total_energy_to_formation_gibbs(
    dir: str,
    elements_list,
    temperature_kelvin: float = 0.0,
    overwrite_data: bool = False,
) -> str:
    """Rewrite an LSMS directory with formation Gibbs energy targets
    (reference ``convert_raw_data_energy_to_gibbs``). Binary alloys only;
    requires one pure-element file per element. Returns the new directory."""
    dir = dir.rstrip("/")
    new_dir = dir + "_gibbs_energy/"
    if os.path.exists(new_dir):
        if overwrite_data:
            shutil.rmtree(new_dir)
        else:
            return new_dir
    os.makedirs(new_dir)

    elements_list = sorted(elements_list)
    pure_elements_energy: dict = {}
    all_files = sorted(os.listdir(dir))
    for filename in all_files:
        total_energy_txt, atoms, _ = _read_lsms(os.path.join(dir, filename))
        uniq = np.unique(atoms[:, 0])
        if len(uniq) == 1:
            pure_elements_energy[uniq[0]] = float(total_energy_txt) / atoms.shape[0]
    if len(pure_elements_energy) != 2:
        raise ValueError(
            f"need exactly two pure-element files, found {len(pure_elements_energy)}"
        )

    gibbs_list = []
    for filename in all_files:
        path = os.path.join(dir, filename)
        total_energy_txt, atoms, txt = _read_lsms(path)
        _, _, formation_enthalpy, entropy = compute_formation_enthalpy(
            atoms[:, 0], float(total_energy_txt), elements_list, pure_elements_energy
        )
        gibbs = formation_enthalpy - temperature_kelvin * entropy
        gibbs_list.append(gibbs)
        txt[0] = txt[0].replace(total_energy_txt, str(gibbs), 1)
        with open(os.path.join(new_dir, filename), "w") as wf:
            wf.write("".join(txt))
    return new_dir


def find_bin(comp: float, nbins: int) -> int:
    """Reference ``find_bin``: open-interval bin lookup over [0, 1]."""
    bins = np.linspace(0, 1, nbins)
    for bi in range(len(bins) - 1):
        if bins[bi] < comp < bins[bi + 1]:
            return bi
    return nbins - 1


def compositional_histogram_cutoff(
    dir: str,
    elements_list,
    histogram_cutoff: int,
    num_bins: int,
    overwrite_data: bool = False,
) -> str:
    """Cap samples per binary-composition bin by linking the survivors into
    ``<dir>_histogram_cutoff/`` (reference behavior, symlinks preserved)."""
    dir = dir.rstrip("/")
    new_dir = dir + "_histogram_cutoff/"
    if os.path.exists(new_dir):
        if overwrite_data:
            shutil.rmtree(new_dir)
        else:
            return new_dir
    os.makedirs(new_dir)

    elements_list = sorted(elements_list)
    comp_all = np.zeros(num_bins)
    for filename in sorted(os.listdir(dir)):
        path = os.path.join(dir, filename)
        atoms = np.loadtxt(path, skiprows=1)
        if atoms.ndim == 1:
            atoms = atoms[None, :]
        elements, counts = np.unique(atoms[:, 0], return_counts=True)
        elements = list(elements)
        counts = list(counts)
        for i, elem in enumerate(elements_list):
            if elem not in elements:
                elements.insert(i, elem)
                counts.insert(i, 0)
        composition = counts[0] / atoms.shape[0]
        b = find_bin(composition, num_bins)
        comp_all[b] += 1
        if comp_all[b] < histogram_cutoff:
            os.symlink(os.path.abspath(path), os.path.join(new_dir, filename))
    return new_dir
