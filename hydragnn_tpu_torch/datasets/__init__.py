"""Datasets: the in-memory fixtures (the deterministic BCC set, the
Lennard-Jones MLIP set), the raw-format readers (LSMS, XYZ, CFG, pickle,
HDF5, ADIOS ``.bp``), the packed store and the sharded sample exchange.

Counterpart of ``hydragnn_tpu/datasets/__init__.py``."""

import os

from .cfg import load_cfg_dir, read_cfg_file  # noqa: F401
from .lennard_jones import lennard_jones_data, lj_energy_forces  # noqa: F401
from .lsms import load_lsms_dir, read_lsms_file, write_lsms_file  # noqa: F401
from .packed import GlobalShuffleStore, PackedDataset, PackedWriter  # noqa: F401
from .pickledataset import SimplePickleDataset, SimplePickleWriter  # noqa: F401
from .sharded import ShardedStore, ShardServer  # noqa: F401
from .synthetic import deterministic_graph_data  # noqa: F401
from .xyz import load_xyz_dir, read_xyz_file  # noqa: F401


def load_raw_dataset(config: dict):
    """Read ``Dataset.path`` by ``Dataset.format`` (LSMS, XYZ, CFG, pickle,
    packed, adios/bp, hdf5) into a list of ``GraphSample``s, as the JAX
    package's ``load_raw_dataset`` does."""
    ds = config["Dataset"]
    fmt = (ds.get("format") or "").lower()
    path = ds.get("path")
    if isinstance(path, dict):
        path = path.get("total") or next(iter(path.values()))
    if fmt == "lsms":
        return load_lsms_dir(path, charge_density_update=ds.get("charge_density", False))
    if fmt == "xyz":
        if os.path.isfile(path):
            return read_xyz_file(path)
        return load_xyz_dir(path)
    if fmt == "cfg":
        return load_cfg_dir(path)
    if fmt == "pickle":
        return SimplePickleDataset(path, ds.get("label", "total")).load_all()
    if fmt == "packed":
        return PackedDataset(path).load_all()
    if fmt in ("adios", "bp"):
        from .convert import read_bp_dataset

        return read_bp_dataset(path, label=ds.get("label", "trainset"))
    if fmt in ("hdf5", "h5"):
        from .hdf5 import read_hdf5

        return read_hdf5(path, flavor=ds.get("hdf5_flavor", "auto"))
    raise ValueError(
        f"Dataset format '{fmt}' has no registered loader; supported: "
        "LSMS, XYZ, CFG, pickle, packed, adios/bp, hdf5 (or pass samples= "
        "directly)"
    )


__all__ = [
    "GlobalShuffleStore",
    "PackedDataset",
    "PackedWriter",
    "ShardServer",
    "ShardedStore",
    "SimplePickleDataset",
    "SimplePickleWriter",
    "deterministic_graph_data",
    "lennard_jones_data",
    "lj_energy_forces",
    "load_cfg_dir",
    "load_lsms_dir",
    "load_raw_dataset",
    "load_xyz_dir",
    "read_cfg_file",
    "read_lsms_file",
    "read_xyz_file",
    "write_lsms_file",
]
