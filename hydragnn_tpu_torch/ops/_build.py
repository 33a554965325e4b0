"""Build and load the package's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

The library is built at first use from ``hydragnn_tpu_torch/csrc`` into
``build/`` at the repository root, under a name that carries a hash of the
sources and flags, so an edited source is never served by a stale library.
Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
SOURCES = ("segment_reduce.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_LOG: dict = {}  # seconds, command, ptxas output of the last build/load


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the CUDA "
        "kernels of hydragnn_tpu_torch are built from source at first use"
    )


def _library_path() -> Path:
    h = hashlib.sha1()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsegment_reduce-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists.
    Writes to a temporary name and renames, so concurrent builds never
    load a half-written library."""
    target = _library_path()
    if target.exists():
        BUILD_LOG.update(seconds=0.0, cached=True, path=str(target))
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, target)
    BUILD_LOG.update(
        seconds=seconds, cached=False, path=str(target), command=" ".join(cmd),
        ptxas=(proc.stdout + proc.stderr).strip(),
    )
    return target


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes set:
    every pointer and the stream as ``c_void_p``, sizes as ``c_int``."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gather_scatter_sum_fwd.argtypes = [
            i32, vp, vp, vp, i32, vp, vp, vp, vp, vp, i32, i32, i32, i32, vp,
        ]
        lib.gather_scatter_sum_fwd.restype = i32
        lib.segment_sum_fwd.argtypes = [i32, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, vp]
        lib.segment_sum_fwd.restype = i32
        _lib = lib
        return lib


__all__ = ["BUILD_DIR", "BUILD_LOG", "build", "find_nvcc", "load"]
