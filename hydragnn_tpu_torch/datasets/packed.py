"""Packed-record dataset format — the scale-out data plane.

Counterpart of ``hydragnn_tpu/datasets/packed.py``, byte for byte: a file
either package writes for the same samples is the same bytes, and each
package reads the other's.

Reference design: ADIOS2 .bp files with per-key concatenated global arrays,
one ragged dimension, and ``variable_count``/``variable_offset`` index arrays
plus global attributes (minmax, pna_deg, dataset_name) — ``hydragnn/utils/
datasets/adiosdataset.py:48-352``. The same count/offset index design in a
single flat file:

    [8B magic 'GPKDATA1'][8B header_len]
    [per key: counts int64[n_samples], then concatenated row-major data]
    [header JSON][8B header_len]

Header JSON: {"n_samples": N, "keys": [{"name", "dtype", "cols", "offset",
"counts_offset"}...], "attrs": {...}}. Every key is a per-node/edge/graph
array with a leading ragged dimension; scalars are 1-row keys. The store
keeps float32 and int32: float64 fields lose their precision on the way
through a file.

Reads are zero-copy ``np.memmap`` slices: a sample read from a file holds
READ-ONLY views (an in-place write raises; the pipeline assigns new arrays);
per-host shard windows (``subset``) reproduce AdiosDataset's ``setsubset``
(``:864-890``).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..graphs.graph import GraphSample

MAGIC = b"GPKDATA1"

# GraphSample fields serialized per sample: (name, dtype, trailing_cols_fn)
_FIELDS = (
    ("x", np.float32),
    ("pos", np.float32),
    ("senders", np.int32),
    ("receivers", np.int32),
    ("edge_attr", np.float32),
    ("edge_shifts", np.float32),
    ("graph_y", np.float32),
    ("node_y", np.float32),
    ("energy_y", np.float32),
    ("forces_y", np.float32),
    ("graph_attr", np.float32),
    ("node_table", np.float32),
    ("graph_table", np.float32),
)


def _field_value(s: GraphSample, name: str) -> np.ndarray:
    if name in ("node_table", "graph_table"):
        v = s.extras.get(name)
        if v is None:
            return np.zeros((0, 1), np.float32)
        v = np.asarray(v)
        return v.reshape(-1, v.shape[-1]) if v.ndim > 1 else v.reshape(-1, 1)
    v = getattr(s, name)
    v = np.asarray(v)
    return v.reshape(-1, 1) if v.ndim == 1 else v


class PackedWriter:
    """Serialize a list of GraphSamples into one packed file."""

    def __init__(self, samples, path: str, attrs: dict | None = None):
        n = len(samples)
        keys = []
        blobs = []
        for name, dtype in _FIELDS:
            vals = [_field_value(s, name).astype(dtype) for s in samples]
            # zero-width columns (e.g. absent edge_attr) are preserved as 0
            widths = {v.shape[1] for v in vals}
            if len(widths) > 1:
                raise ValueError(
                    f"key '{name}' has inconsistent column widths {sorted(widths)} "
                    "across samples; packed files require a homogeneous schema"
                )
            cols = widths.pop() if widths else 1
            counts = np.array([v.shape[0] for v in vals], np.int64)
            # per-graph vectors (graph_y targets, graph_attr conditioning)
            # ride the ragged dim with cols=1, so the width check above can't
            # catch per-sample length mismatches — which would collate into
            # broadcast errors far from the write site
            if name in ("graph_y", "graph_attr") and len(np.unique(counts)) > 1:
                raise ValueError(
                    f"{name} length differs across samples "
                    f"({sorted(set(counts.tolist()))}); per-graph vectors "
                    "must be homogeneous (or absent everywhere)"
                )
            data = (
                np.concatenate(vals, axis=0)
                if vals
                else np.zeros((0, cols), dtype)
            )
            keys.append(
                {"name": name, "dtype": np.dtype(dtype).str, "cols": int(cols)}
            )
            blobs.append((counts, np.ascontiguousarray(data)))

        # extra per-sample scalars
        dsid = np.array([s.dataset_id for s in samples], np.int32).reshape(-1, 1)
        keys.append({"name": "dataset_id", "dtype": "<i4", "cols": 1})
        blobs.append((np.ones(n, np.int64), dsid))

        offset = 0
        payload = []
        for k, (counts, data) in zip(keys, blobs):
            k["counts_offset"] = offset
            offset += counts.nbytes
            k["offset"] = offset
            offset += data.nbytes
            payload.append((counts, data))

        # size stats let loaders build pad specs without a full scan
        final_attrs = dict(attrs or {})
        if samples:
            final_attrs.setdefault(
                "max_nodes", int(max(s.num_nodes for s in samples))
            )
            final_attrs.setdefault(
                "max_edges", int(max(s.num_edges for s in samples))
            )
        header = json.dumps(
            {"n_samples": n, "keys": keys, "attrs": final_attrs}
        ).encode()
        with open(path, "wb") as f:
            f.write(MAGIC)
            f.write(np.int64(len(header)).tobytes())
            for counts, data in payload:
                f.write(counts.tobytes())
                f.write(data.tobytes())
            f.write(header)
            f.write(np.int64(len(header)).tobytes())  # trailer for locating header


class PackedDataset:
    """Memory-mapped reads with per-process subset windows."""

    def __init__(self, path: str, subset: range | None = None):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != MAGIC:
                raise ValueError(f"{path}: not a packed dataset (magic {magic!r})")
            f.seek(-8, os.SEEK_END)
            header_len = int(np.frombuffer(f.read(8), np.int64)[0])
            f.seek(-8 - header_len, os.SEEK_END)
            self.meta = json.loads(f.read(header_len))
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self._base = 16  # magic + header_len prefix
        self._keys = {k["name"]: k for k in self.meta["keys"]}
        self._counts = {}
        self._offsets = {}
        n = self.meta["n_samples"]
        for k in self.meta["keys"]:
            c = np.frombuffer(
                self._mm, np.int64, count=n, offset=self._base + k["counts_offset"]
            )
            self._counts[k["name"]] = c
            self._offsets[k["name"]] = np.concatenate(
                [[0], np.cumsum(c)]
            )  # row offsets
        self.subset = subset if subset is not None else range(n)

    def __len__(self) -> int:
        return len(self.subset)

    @property
    def attrs(self) -> dict:
        return self.meta.get("attrs", {})

    def _read(self, name: str, i: int) -> np.ndarray:
        k = self._keys[name]
        dtype = np.dtype(k["dtype"])
        cols = k["cols"]
        row0 = self._offsets[name][i]
        rows = self._counts[name][i]
        start = self._base + k["offset"] + row0 * cols * dtype.itemsize
        out = np.frombuffer(
            self._mm, dtype, count=rows * cols, offset=int(start)
        ).reshape(rows, cols)
        return out

    def __getitem__(self, idx: int) -> GraphSample:
        i = self.subset[idx]
        get = self._read
        s = GraphSample(
            x=get("x", i),
            pos=get("pos", i),
            senders=get("senders", i)[:, 0],
            receivers=get("receivers", i)[:, 0],
            edge_attr=get("edge_attr", i),
            edge_shifts=get("edge_shifts", i),
            graph_y=get("graph_y", i)[:, 0],
            node_y=get("node_y", i),
            energy_y=get("energy_y", i)[:, 0],
            forces_y=get("forces_y", i),
            # absent from pre-graph_attr files: stays None -> zero-width
            graph_attr=(
                get("graph_attr", i)[:, 0]
                if "graph_attr" in self._keys and self._counts["graph_attr"][i]
                else None
            ),
            dataset_id=int(get("dataset_id", i)[0, 0]),
        )
        nt = get("node_table", i)
        gt = get("graph_table", i)
        if nt.size:
            s.extras["node_table"] = nt
        if gt.size:
            s.extras["graph_table"] = gt[:, 0]
        return s

    def sample_sizes(self, indices) -> np.ndarray:
        """[k, 2] (num_nodes, num_edges) per sample straight from the
        count index — size queries (bucket planning) never materialize
        sample content."""
        idx = np.fromiter((self.subset[int(i)] for i in indices), np.int64,
                          count=len(indices))
        return np.stack(
            [self._counts["x"][idx], self._counts["senders"][idx]], axis=1
        )

    def load_all(self) -> list[GraphSample]:
        return [self[i] for i in range(len(self))]

    def setsubset(self, start: int, stop: int) -> "PackedDataset":
        """Per-rank shard window (AdiosDataset.setsubset semantics)."""
        self.subset = range(start, stop)
        return self


def pad_spec_from_stats(
    attrs: dict, batch_size: int, node_multiple: int = 8,
    edge_multiple: int = 128,
):
    """PadSpec from writer-recorded ``max_nodes``/``max_edges`` stats — the
    ONE place the padding formula lives (GlobalShuffleStore and ShardedStore
    both derive their static shapes here, so they can never diverge)."""
    from ..graphs.batching import PadSpec

    if "max_nodes" not in attrs:
        raise ValueError("packed file lacks size stats; re-write with PackedWriter")
    import math

    def up(v, m):
        return int(math.ceil(max(v, 1) / m) * m)

    return PadSpec(
        n_node=up(attrs["max_nodes"] * batch_size + 1, node_multiple),
        n_edge=up(attrs["max_edges"] * batch_size + 1, edge_multiple),
        n_graph=batch_size + 1,
    )


class GlobalShuffleStore:
    """DDStore-equivalent cross-host sample store (reference
    ``hydragnn/utils/datasets/distdataset.py:72-367`` and AdiosDataset's
    remote-read mode ``adiosdataset.py:643-757``).

    The reference needs an in-RAM distributed store with remote ``get()``
    fetches because each rank materializes only its window of the dataset.
    The packed format already gives every host O(1) random access to ANY
    sample by offset (mmap + count/offset index; the OS page cache is the
    shared RAM tier), so cross-host global shuffle needs no message passing
    at all: every rank derives the SAME per-epoch permutation from the shared
    seed and lazily reads its stride-slice — the "index exchange" is
    deterministic replay instead of communication.

    This object is a lazy Sequence over the whole file: feed it straight to
    ``GraphLoader(..., rank, world, shuffle=True)`` and each host's stream
    (a) spans the entire dataset across epochs instead of a fixed window and
    (b) reshuffles globally every epoch — the two DDStore properties the
    per-host ``setsubset`` windows lack.
    """

    def __init__(self, path: str):
        self.ds = PackedDataset(path)

    def __len__(self) -> int:
        return self.ds.meta["n_samples"]

    def __getitem__(self, i: int) -> GraphSample:
        return self.ds[int(i)]

    def sample_sizes(self, indices) -> np.ndarray:
        return self.ds.sample_sizes(indices)

    @property
    def attrs(self) -> dict:
        return self.ds.attrs

    def pad_spec(self, batch_size: int, node_multiple: int = 8, edge_multiple: int = 128):
        """PadSpec from writer-recorded size stats — no full scan."""
        return pad_spec_from_stats(self.attrs, batch_size, node_multiple,
                                   edge_multiple)

    def loader(
        self,
        batch_size: int,
        rank: int = 0,
        world: int = 1,
        seed: int = 0,
        shuffle: bool = True,
        pad=None,
        **kw,
    ):
        from ..graphs.batching import GraphLoader

        return GraphLoader(
            self,
            batch_size,
            pad=pad or self.pad_spec(batch_size),
            shuffle=shuffle,
            seed=seed,
            rank=rank,
            world=world,
            **kw,
        )
