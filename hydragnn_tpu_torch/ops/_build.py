"""Build and load the package's CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, loaded with ``ctypes``.

Each source of ``hydragnn_tpu_torch/csrc`` is built at first use into its
own library in ``build/`` at the repository root, all ``nvcc`` processes
started together, under a name that carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or header
is never served by a stale library. Nothing here
runs at import time: the CPU tests import every module of the package on
machines without ``nvcc``.
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# source -> {C function: argtypes}; every function returns a cudaError_t (int)
SOURCES = {
    "segment_reduce.cu": {
        "gather_scatter_sum_fwd": [_i32, _vp, _vp, _vp, _i32] + [_vp] * 7 + [_i32] * 4 + [_vp],
        "segment_sum_fwd": [_i32] + [_vp] * 8 + [_i32] * 4 + [_vp],
    },
    "segment_softmax.cu": {
        "segment_softmax_fwd": [_i32] + [_vp] * 8 + [_i32] * 4 + [_vp],
        "segment_softmax_stats": [_i32] + [_vp] * 9 + [_i32] * 4 + [_vp],
        "segment_softmax_normalise": [_i32] + [_vp] * 8 + [_i32] * 4 + [_vp],
        "masked_softmax_fwd": [_i32, _vp, _vp, _vp, _i32, _i32, _i32, _vp],
    },
    "cell_list.cu": {
        "cell_list_atoms_per_cta": [],
        "cell_list_edges": [_vp] * 8 + [_i32] * 5 + [_f32, _i32] + [_vp] * 7,
    },
    "quant_matmul.cu": {
        "quant_dense_fwd": [_i32, _vp, _vp, _vp, _vp, _f32, _vp, _vp, _vp, _i32, _i32, _i32,
                            _vp],
    },
    "fp8_matmul.cu": {
        "fp8_dense_fwd": [_i32] + [_vp] * 7 + [_i32] * 3 + [_vp],
    },
}

_lock = threading.Lock()
_lib: "Kernels | None" = None
# per source: seconds, cached, path, command and ptxas output of the last
# build; "seconds" at the top level is the wall time of the whole build
BUILD_LOG: dict = {}


class Kernels:
    """The loaded libraries' C functions as attributes."""

    def __init__(self, functions: dict):
        self.__dict__.update(functions)


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the CUDA "
        "kernels of hydragnn_tpu_torch are built from source at first use"
    )


def _library_path(source: str) -> Path:
    h = hashlib.sha1((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers a source may include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build() -> dict[str, Path]:
    """Compile every source whose library for these exact bytes is missing,
    one ``nvcc`` per source, all at once. Each writes to a temporary name and
    renames, so concurrent builds never load a half-written library."""
    t0 = time.perf_counter()
    targets = {s: _library_path(s) for s in SOURCES}
    running = {}
    for source, target in targets.items():
        if target.exists():
            BUILD_LOG[source] = dict(seconds=0.0, cached=True, path=str(target))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running[source] = (proc, cmd, tmp, time.perf_counter())
    failures = []
    for source, (proc, cmd, tmp, t_start) in running.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{output}")
            continue
        os.replace(tmp, targets[source])
        BUILD_LOG[source] = dict(seconds=time.perf_counter() - t_start, cached=False,
                                 path=str(targets[source]), command=" ".join(cmd),
                                 ptxas=output.strip())
    if failures:
        raise RuntimeError("\n".join(failures))
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    return targets


def load() -> Kernels:
    """The kernels' C functions (built on first call), with argtypes set:
    every pointer and the stream as ``c_void_p``, sizes as ``c_int``, a
    float scalar as ``c_float``."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        functions = {}
        for source, path in build().items():
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SOURCES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _i32
                functions[name] = fn
        _lib = Kernels(functions)
        return _lib


__all__ = ["BUILD_DIR", "BUILD_LOG", "Kernels", "build", "find_nvcc", "load"]
