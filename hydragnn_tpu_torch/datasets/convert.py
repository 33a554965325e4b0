"""Real-dataset ingestion: public structure files → the packed record store.

Counterpart of ``hydragnn_tpu/datasets/convert.py``: for the same input the
CLI writes the JAX CLI's bytes. The reference trains its headline workloads
from public corpora — QM9 raw xyz, OC20/OMat24 via ASE/LMDB readers
(reference ``examples/open_catalyst_2020/train.py``,
``hydragnn/preprocess/raw_dataset_loader.py:26-277``), LSMS/CFG text. This
module reads any supported on-disk format into ``GraphSample``s, builds
(PBC-aware) radius graphs, and writes one ``PackedWriter`` store.

CLI:

    python -m hydragnn_tpu_torch.datasets.convert INPUT OUTPUT.gpk \
        [--radius 5.0] [--max-neighbours 40] [--limit N] [--name NAME]

Supported inputs (by extension / shape):

* ``.xyz`` / ``.extxyz`` — (extended) XYZ, multi-frame; QM9's raw flavor
  (``gdb`` comment line, ``*^`` float exponents) is auto-detected and its 15
  scalar targets stored columnar in ``graph_table``;
* directory of ``.xyz`` files — e.g. an unpacked QM9 download;
* ``.cfg`` — AtomEye/MTP configurations;
* LSMS text directory (``--format lsms``);
* ``.h5`` / ``.hdf5`` — ANI1x / qm7x corpora, when ``h5py`` is installed;
* ``.db`` / ``.traj`` — ASE databases, when ``ase`` is installed;
* ``.lmdb`` — OC20 S2EF LMDBs, when ``lmdb`` is installed;
* ``.bp`` — ADIOS stores written by the reference, when ``adios2`` is
  installed.

The optional libraries are imported at first use; without them the reader
raises ``ImportError`` with the JAX package's message.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..graphs.graph import GraphSample


def attach_radius_graph(
    samples: list[GraphSample],
    radius: float,
    max_neighbours: int | None = None,
    progress_every: int = 0,
) -> list[GraphSample]:
    """Build each sample's neighbor list in place (PBC-aware when the sample
    carries a cell). Skips samples that already have edges."""
    from ..graphs.radius import build_radius_graph

    for i, s in enumerate(samples):
        if s.num_edges:
            continue
        build_radius_graph(s, radius, max_neighbours=max_neighbours)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"  neighbor lists: {i + 1}/{len(samples)}", file=sys.stderr)
    return samples


def _read_ase(path: str, limit: int | None = None) -> list[GraphSample]:
    try:
        from ase.io import iread
    except ImportError as exc:
        raise ImportError(
            f"reading {path!r} needs the 'ase' package (not installed); "
            "export your data to extended XYZ instead: "
            "`ase convert in.db out.extxyz`"
        ) from exc
    out = []
    for atoms in iread(path):
        if limit is not None and len(out) >= limit:
            break
        out.append(sample_from_ase_atoms(atoms))
    return out


def sample_from_ase_atoms(atoms) -> GraphSample:
    """ASE ``Atoms`` (duck-typed) -> edge-less ``GraphSample``. Factored out
    of the file reader so the parsing is testable without the ``ase``
    package."""
    energy = 0.0
    forces = None
    try:
        energy = float(atoms.get_potential_energy())
        forces = np.asarray(atoms.get_forces())
    except Exception:
        pass
    z = np.asarray(atoms.get_atomic_numbers()).astype(np.float64).reshape(-1, 1)
    pbc = np.asarray(atoms.pbc)
    return GraphSample(
        x=z,
        pos=np.asarray(atoms.get_positions()),
        energy_y=np.array([energy]),
        forces_y=forces,
        cell=np.asarray(atoms.get_cell()) if pbc.any() else None,
        pbc=pbc if pbc.any() else None,
        extras={"node_table": z, "graph_table": np.array([energy])},
    )


def sample_from_fairchem(d) -> GraphSample:
    """fairchem/OCP ``Data`` record (duck-typed: ``atomic_numbers``, ``pos``,
    optional ``y``/``force``/``cell``) -> edge-less ``GraphSample``."""
    z = np.asarray(d.atomic_numbers, np.float64).reshape(-1, 1)
    cell = np.asarray(d.cell).reshape(3, 3) if getattr(d, "cell", None) is not None else None
    energy = float(getattr(d, "y", 0.0) or 0.0)
    force = getattr(d, "force", None)
    return GraphSample(
        x=z,
        pos=np.asarray(d.pos),
        energy_y=np.array([energy]),
        forces_y=np.asarray(force) if force is not None else None,
        cell=cell,
        pbc=np.array([True, True, True]) if cell is not None else None,
        extras={"node_table": z, "graph_table": np.array([energy])},
    )


def _decode_length(val) -> int | None:
    """The OC20/fairchem S2EF LMDBs store the ``length`` key PICKLED; older /
    hand-built stores use ascii. Try pickle first, then an int decode
    (``.decode()`` alone raises UnicodeDecodeError on a real OC20 LMDB)."""
    if val is None:
        return None
    import pickle

    try:
        return int(pickle.loads(val))
    except Exception:
        try:
            return int(val.decode())
        except Exception:
            return None


def _read_oc20_lmdb(path: str, limit: int | None = None) -> list[GraphSample]:
    try:
        import lmdb  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            f"reading {path!r} needs the 'lmdb' package (not installed); "
            "convert the trajectory to extended XYZ first"
        ) from exc
    import pickle

    env = lmdb.open(
        path, subdir=False, readonly=True, lock=False, readahead=False, meminit=False
    )
    out = []
    with env.begin() as txn:
        n = _decode_length(txn.get(b"length"))
        cur = txn.cursor()
        for key, val in cur:
            if key == b"length":
                continue
            d = pickle.loads(val)  # fairchem Data object (duck-typed access)
            out.append(sample_from_fairchem(d))
            if (n and len(out) >= n) or (limit is not None and len(out) >= limit):
                break
    return out


# reference PyG Data keys -> GraphSample fields (adiosdataset.py write
# layout); edge_index is handled separately (split into senders/receivers)
_BP_FIELD_MAP = {
    "x": "x", "pos": "pos", "edge_attr": "edge_attr",
    "edge_shifts": "edge_shifts", "y": "graph_y", "energy": "energy_y",
    "forces": "forces_y", "cell": "cell", "pbc": "pbc",
}


def _open_bp(path: str):
    """Version-tolerant adios2 read handle: FileReader (>= 2.9) or the
    legacy ``adios2.open`` stream API. Returns (attrs: dict, read: name ->
    ndarray, close)."""
    try:
        import adios2
    except ImportError as e:
        raise ImportError(
            "reading ADIOS .bp stores needs the adios2 package "
            "(pip install adios2); alternatively re-convert the raw corpus "
            "with hydragnn_tpu_torch.datasets.convert"
        ) from e

    if hasattr(adios2, "FileReader"):
        fh = adios2.FileReader(path)
        attrs = {}
        for name in fh.available_attributes():
            a = fh.inquire_attribute(name)
            v = a.data_string() if a.type() == "string" else np.asarray(a.data())
            attrs[name] = v
        return attrs, (lambda name: np.asarray(fh.read(name))), fh.close
    fh = adios2.open(path, "r")  # legacy API
    attrs = {}
    for name, info in fh.available_attributes().items():
        v = info.get("Value", "")
        if info.get("Type") == "string":
            attrs[name] = [s.strip().strip('"') for s in v.strip("{}").split(",")]
        else:
            attrs[name] = np.fromstring(v.strip("{}"), sep=",")
    return attrs, (lambda name: np.asarray(fh.read(name))), fh.close


def read_bp_dataset(
    path: str, label: str = "trainset", limit: int | None = None
) -> list[GraphSample]:
    """Read-only importer for a reference-HydraGNN-written ADIOS ``.bp``
    store (write layout ``hydragnn/utils/datasets/adiosdataset.py:100-264``:
    per key one concatenated global array along ``variable_dim`` plus
    ``variable_count``/``variable_offset`` index arrays). Anyone migrating
    from the reference points this at their existing corpus instead of
    re-converting raw files."""
    attrs, read, close = _open_bp(path)
    try:
        keys = attrs.get(f"{label}/keys")
        if keys is None:
            have = sorted(
                k.split("/")[0] for k in attrs if k.endswith("/keys")
            )
            raise ValueError(
                f"{path}: no label {label!r} (available: {have})"
            )
        keys = [k.decode() if isinstance(k, bytes) else str(k) for k in keys]
        ndata = int(np.asarray(attrs[f"{label}/ndata"]).ravel()[0])
        n = ndata if limit is None else min(ndata, limit)
        per_key = {}
        for k in keys:
            if k == "dataset_name":
                continue
            arr = read(f"{label}/{k}")
            vdim = int(
                np.asarray(attrs.get(f"{label}/{k}/variable_dim", 0)).ravel()[0]
            )
            count = read(f"{label}/{k}/variable_count").astype(np.int64)
            offset = read(f"{label}/{k}/variable_offset").astype(np.int64)
            per_key[k] = (arr, vdim, count, offset)
        samples = []
        for i in range(n):
            fields = {}
            for k, (arr, vdim, count, offset) in per_key.items():
                sl = [slice(None)] * arr.ndim
                sl[vdim] = slice(offset[i], offset[i] + count[i])
                fields[k] = np.asarray(arr[tuple(sl)])
            samples.append(_sample_from_bp_fields(fields))
        return samples
    finally:
        close()


def _sample_from_bp_fields(fields: dict) -> GraphSample:
    kw = {}
    extras = {}
    ei = fields.pop("edge_index", None)
    for k, v in fields.items():
        if k in _BP_FIELD_MAP:
            kw[_BP_FIELD_MAP[k]] = v
        else:
            extras[k] = v
    s = GraphSample(**kw)
    if ei is not None:
        ei = np.asarray(ei, np.int64).reshape(2, -1)
        s.senders, s.receivers = ei[0], ei[1]
        if s.edge_shifts is None or len(s.edge_shifts) != s.senders.size:
            # .bp stores without per-edge shifts (open-boundary corpora):
            # zero shifts, matching the in-cell edge convention
            s.edge_shifts = np.zeros((s.senders.size, 3), np.float32)
    # reference semantics: Data.x is the FULL node-feature table and y the
    # graph-target vector — expose them as the columnar tables so
    # Variables_of_interest column selection works downstream. (Node-level
    # targets inside the reference's y_loc-encoded y are ambiguous without
    # y_loc and must travel as their own .bp keys.)
    if s.x is not None:
        s.extras.setdefault("node_table", np.asarray(s.x))
    if s.graph_y is not None:
        s.extras.setdefault(
            "graph_table", np.asarray(s.graph_y, np.float64).reshape(-1)
        )
    s.extras.update(extras)
    return s


def read_structures(
    path: str, fmt: str | None = None, limit: int | None = None
) -> list[GraphSample]:
    """Read any supported input into (edge-less) ``GraphSample``s."""
    from .cfg import read_cfg_file
    from .lsms import load_lsms_dir
    from .xyz import load_xyz_dir, read_xyz_file

    ext = os.path.splitext(path)[1].lower()
    if fmt == "lsms":
        return load_lsms_dir(path)[:limit]
    if ext == ".bp":  # ADIOS stores are directories — route before isdir
        return read_bp_dataset(path, limit=limit)
    if os.path.isdir(path):
        return load_xyz_dir(path, limit=limit)
    if ext in (".xyz", ".extxyz"):
        return read_xyz_file(path, limit=limit)
    if ext == ".cfg":
        return [read_cfg_file(path)][:limit]
    if ext in (".db", ".traj"):
        return _read_ase(path, limit=limit)
    if ext == ".lmdb":
        return _read_oc20_lmdb(path, limit=limit)
    if ext in (".h5", ".hdf5"):
        from .hdf5 import read_hdf5

        return read_hdf5(path, limit=limit)
    raise ValueError(
        f"unrecognized dataset input {path!r} (expected .xyz/.extxyz/.cfg/"
        ".db/.traj/.lmdb/.h5/.hdf5/.bp, a directory of .xyz files, or "
        "--format lsms)"
    )


def convert_to_packed(
    input_path: str,
    output_path: str,
    radius: float = 5.0,
    max_neighbours: int | None = 40,
    fmt: str | None = None,
    limit: int | None = None,
    dataset_name: str | None = None,
) -> int:
    """Read ``input_path``, build radius graphs, write a packed store.
    Returns the number of structures written."""
    from .packed import PackedWriter

    samples = read_structures(input_path, fmt=fmt, limit=limit)
    if not samples:
        raise ValueError(f"no structures found in {input_path!r}")
    attach_radius_graph(samples, radius, max_neighbours, progress_every=1000)
    PackedWriter(
        samples,
        output_path,
        attrs={
            "dataset_name": dataset_name or os.path.basename(input_path),
            "source": os.path.abspath(input_path),
            "radius": radius,
            "max_neighbours": max_neighbours or 0,
        },
    )
    return len(samples)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Convert a public structure file to a packed training store"
    )
    ap.add_argument(
        "input",
        help=".xyz/.extxyz/.cfg/.db/.traj/.lmdb/.h5/.hdf5/.bp file or xyz dir",
    )
    ap.add_argument("output", help="output packed store (.gpk)")
    ap.add_argument("--radius", type=float, default=5.0)
    ap.add_argument("--max-neighbours", type=int, default=40)
    ap.add_argument("--format", dest="fmt", default=None, choices=[None, "lsms"])
    ap.add_argument("--limit", type=int, default=None, help="convert first N only")
    ap.add_argument("--name", default=None, help="dataset_name attr")
    args = ap.parse_args(argv)
    n = convert_to_packed(
        args.input,
        args.output,
        radius=args.radius,
        max_neighbours=args.max_neighbours,
        fmt=args.fmt,
        limit=args.limit,
        dataset_name=args.name,
    )
    print(f"wrote {n} structures -> {args.output}")


if __name__ == "__main__":
    main()
