"""Simple pickle dataset: one file per sample + a metadata pickle.

Counterpart of ``hydragnn_tpu/datasets/pickledataset.py`` (its files hold
the port's ``GraphSample``s).

Reference: ``hydragnn/utils/datasets/pickledataset.py:14-183``
(``SimplePickleWriter``/``SimplePickleDataset``), including the optional
subdirectory sharding per 10k samples so directories stay listable.
"""

from __future__ import annotations

import os
import pickle

from ..graphs.graph import GraphSample

_PER_DIR = 10_000


def _sample_path(basedir: str, label: str, i: int, use_subdir: bool) -> str:
    if use_subdir:
        sub = os.path.join(basedir, str(i // _PER_DIR))
        os.makedirs(sub, exist_ok=True)
        return os.path.join(sub, f"{label}-{i}.pkl")
    return os.path.join(basedir, f"{label}-{i}.pkl")


class SimplePickleWriter:
    def __init__(
        self,
        samples,
        basedir: str,
        label: str = "total",
        use_subdir: bool = False,
        attrs: dict | None = None,
    ):
        os.makedirs(basedir, exist_ok=True)
        meta = {
            "total_ns": len(samples),
            "use_subdir": use_subdir,
            "attrs": attrs or {},
        }
        with open(os.path.join(basedir, f"{label}-meta.pkl"), "wb") as f:
            pickle.dump(meta, f)
        for i, s in enumerate(samples):
            with open(_sample_path(basedir, label, i, use_subdir), "wb") as f:
                pickle.dump(s, f)


class SimplePickleDataset:
    """Lazy per-sample reads; supports len/getitem and full materialization."""

    def __init__(self, basedir: str, label: str = "total"):
        with open(os.path.join(basedir, f"{label}-meta.pkl"), "rb") as f:
            self.meta = pickle.load(f)
        self.basedir = basedir
        self.label = label

    def __len__(self) -> int:
        return self.meta["total_ns"]

    @property
    def attrs(self) -> dict:
        return self.meta.get("attrs", {})

    def __getitem__(self, i: int) -> GraphSample:
        path = _sample_path(
            self.basedir, self.label, i, self.meta.get("use_subdir", False)
        )
        with open(path, "rb") as f:
            return pickle.load(f)

    def load_all(self) -> list[GraphSample]:
        return [self[i] for i in range(len(self))]
