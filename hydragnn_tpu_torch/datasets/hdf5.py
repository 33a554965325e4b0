"""HDF5 corpus readers for the SC25 GFM pretraining mix: ANI1x-style and
qm7x-style files (reference ``examples/ani1_x/train.py:236-257`` and
``examples/qm7x/train.py:153-190``). Counterpart of
``hydragnn_tpu/datasets/hdf5.py``: the same samples, field by field.

Two public layouts:

* **ANI1x**: one group per formula, datasets ``atomic_numbers`` [Na] and
  ``coordinates`` [Nc, Na, 3] plus per-conformation property columns
  (``wb97x_dz.energy`` [Nc], ``wb97x_dz.forces`` [Nc, Na, 3], ...). Rows
  with NaN in a requested property are dropped, like the reference.
* **qm7x**: two-level nesting molecule-id -> conformation-id, each
  conformation a group with ``atNUM`` [Na], ``atXYZ`` [Na, 3] and scalar/
  vector properties (``ePBE0+MBD``, ``totFOR``, ...).

``read_hdf5`` sniffs the flavor; ``convert.read_structures`` routes
``.h5``/``.hdf5`` here, so ``python -m hydragnn_tpu_torch.datasets.convert
foo.h5 out.gpk`` ingests either corpus. ``h5py`` is imported at first
use; without it every reader raises ``ImportError``.
"""

from __future__ import annotations

import numpy as np

from ..graphs.graph import GraphSample

# default property columns per flavor (the reference examples' choices)
_ANI1X_ENERGY = "wb97x_dz.energy"
_ANI1X_FORCES = "wb97x_dz.forces"
_QM7X_ENERGY = "ePBE0+MBD"
_QM7X_FORCES = "totFOR"


def _require_h5py():
    try:
        import h5py  # noqa: F401

        return h5py
    except ImportError as e:
        raise ImportError(
            "reading .h5 corpora needs h5py (not installed in this "
            "environment)"
        ) from e


def _sample(z, pos, energy=None, forces=None) -> GraphSample:
    z = np.asarray(z, np.float32).reshape(-1, 1)
    kw = {}
    if energy is not None:
        kw["energy_y"] = np.asarray(energy, np.float32).reshape(1)
        # own buffer, not a view of energy_y: an in-place edit of one target
        # must never silently rewrite the other
        kw["graph_y"] = np.array(kw["energy_y"])
    if forces is not None:
        kw["forces_y"] = np.asarray(forces, np.float32).reshape(-1, 3)
    return GraphSample(x=z, pos=np.asarray(pos, np.float32).reshape(-1, 3), **kw)


def read_ani1x_h5(
    path: str,
    energy_key: str | None = _ANI1X_ENERGY,
    forces_key: str | None = _ANI1X_FORCES,
    limit: int | None = None,
) -> list[GraphSample]:
    """Group-per-formula layout -> one GraphSample per (formula,
    conformation); conformations with NaN in a requested property are
    dropped (reference ``iter_data_buckets``). Missing property columns
    degrade gracefully (coordinates-only corpora still convert)."""
    h5py = _require_h5py()
    out: list[GraphSample] = []
    with h5py.File(path, "r") as f:
        for grp in f.values():
            coords = np.asarray(grp["coordinates"])
            z = np.asarray(grp["atomic_numbers"])
            nc = coords.shape[0]
            e = fo = None
            mask = np.ones(nc, bool)
            if energy_key and energy_key in grp:
                e = np.asarray(grp[energy_key]).reshape(nc, -1)
                mask &= ~np.isnan(e).any(axis=1)
            if forces_key and forces_key in grp:
                fo = np.asarray(grp[forces_key]).reshape(nc, -1)
                mask &= ~np.isnan(fo).any(axis=1)
            for i in np.nonzero(mask)[0]:
                out.append(_sample(
                    z, coords[i],
                    energy=e[i].sum() if e is not None else None,
                    forces=fo[i] if fo is not None else None,
                ))
                if limit is not None and len(out) >= limit:
                    return out
    return out


def read_qm7x_h5(
    path: str,
    energy_key: str | None = _QM7X_ENERGY,
    forces_key: str | None = _QM7X_FORCES,
    limit: int | None = None,
) -> list[GraphSample]:
    """Molecule-id -> conformation-id nesting (reference qm7x loader)."""
    h5py = _require_h5py()
    out: list[GraphSample] = []
    with h5py.File(path, "r") as f:
        for mol in f.values():
            for conf in mol.values():
                e = (
                    np.asarray(conf[energy_key]).sum()
                    if energy_key and energy_key in conf else None
                )
                fo = (
                    np.asarray(conf[forces_key])
                    if forces_key and forces_key in conf else None
                )
                out.append(_sample(conf["atNUM"], conf["atXYZ"],
                                   energy=e, forces=fo))
                if limit is not None and len(out) >= limit:
                    return out
    return out


def read_hdf5(
    path: str, flavor: str = "auto", limit: int | None = None, **kw
) -> list[GraphSample]:
    """Flavor-sniffing entry: top-level groups carrying ``coordinates`` +
    ``atomic_numbers`` datasets -> ANI1x; groups of groups carrying
    ``atXYZ``/``atNUM`` -> qm7x."""
    if flavor == "ani1x":
        return read_ani1x_h5(path, limit=limit, **kw)
    if flavor == "qm7x":
        return read_qm7x_h5(path, limit=limit, **kw)
    if flavor != "auto":
        raise ValueError(f"unknown HDF5 flavor {flavor!r} "
                         "(expected 'auto', 'ani1x', or 'qm7x')")
    h5py = _require_h5py()
    with h5py.File(path, "r") as f:
        for grp in f.values():
            if isinstance(grp, h5py.Group):
                if "coordinates" in grp and "atomic_numbers" in grp:
                    fl = "ani1x"
                    break
                sub = next(iter(grp.values()), None)
                if isinstance(sub, h5py.Group) and "atXYZ" in sub:
                    fl = "qm7x"
                    break
        else:
            raise ValueError(
                f"{path}: neither ANI1x (coordinates/atomic_numbers groups) "
                "nor qm7x (mol/conf/atXYZ nesting) layout"
            )
    return read_hdf5(path, flavor=fl, limit=limit, **kw)


__all__ = ["read_ani1x_h5", "read_hdf5", "read_qm7x_h5"]
