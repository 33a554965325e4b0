"""Native (C++) host helpers, built with ``g++`` at first use and loaded
with ``ctypes``.

Counterpart of ``hydragnn_tpu/native/__init__.py`` over the port's own
copy of ``radius_graph.cpp`` (the multithreaded cell list
``graphs/radius.py`` takes for large point sets).

Each source builds into its own library in ``build/`` at the repository
root (``g++ -O3 -shared -fPIC -std=c++17 ... -lpthread``), under a name
that carries a hash of the source and the flags, as ``ops/_build.py``
names the CUDA libraries: an edited source is never served by a stale
library. The compiler writes to a temporary name that is then renamed into
place, so processes racing on one build never load a half-written file.
There is no fallback: when ``g++`` fails, the call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[1] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
# threads of the native cell list
_THREADS = min(os.cpu_count() or 1, 8)
# source -> {C function: (argtypes, restype)}
SOURCES = {
    "radius_graph.cpp": {
        "pairs_within": ([_f64p, ctypes.c_int64, _f64p, ctypes.c_int64, ctypes.c_double,
                          _i64p, _i64p, ctypes.c_int64, ctypes.c_int], ctypes.c_int64),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def library_path(source: str) -> Path:
    h = hashlib.sha1((_HERE / source).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build(source: str) -> Path:
    """The library of ``source`` for these exact bytes and flags, compiled
    when missing. Raises ``RuntimeError`` when ``g++`` fails or is absent."""
    target = library_path(source)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(_HERE / source), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"building {source} failed: {' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr.strip()}")
    os.replace(tmp, target)
    return target


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built at first use), its functions'
    argument and result types set."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            for fn, (argtypes, restype) in SOURCES[source].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[source] = lib
    return lib


def pairs_within_native(query: np.ndarray, points: np.ndarray,
                        radius: float) -> tuple[np.ndarray, np.ndarray]:
    """All ``(qi, pj)`` with ``||points[pj] - query[qi]|| <= radius`` through
    the native cell list: the same pairs as the numpy cell list of
    ``graphs/radius.py``, in ascending query order (not in the same order
    within a query)."""
    lib = load("radius_graph.cpp")
    q = np.ascontiguousarray(query, np.float64)
    p = np.ascontiguousarray(points, np.float64)
    if q.ndim != 2 or p.ndim != 2 or q.shape[1] != 3 or p.shape[1] != 3:
        raise ValueError(f"pairs_within_native takes [n, 3] point sets, got {q.shape} and "
                         f"{p.shape}")
    nq, npts = q.shape[0], p.shape[0]
    cap = max(64 * nq, 1024)
    for _ in range(2):
        out_q = np.empty(cap, np.int64)
        out_p = np.empty(cap, np.int64)
        n = lib.pairs_within(q.ctypes.data_as(_f64p), nq, p.ctypes.data_as(_f64p), npts,
                             float(radius), out_q.ctypes.data_as(_i64p),
                             out_p.ctypes.data_as(_i64p), cap, _THREADS)
        if n >= 0:
            return out_q[:n], out_p[:n]
        cap = -n  # the second pass always fits: the count is exact
    raise RuntimeError("pairs_within: the pair buffer did not fit twice")


__all__ = ["build", "library_path", "load", "pairs_within_native"]
