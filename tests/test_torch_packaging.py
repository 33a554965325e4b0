"""A built wheel of the port ships every source its kernels and native
helpers are built from at first use: the five ``csrc/*.cu`` files, the
header ``csrc/quant_mma.cuh`` that B6 and B7 include, and
``native/radius_graph.cpp`` (``pyproject.toml``'s package data). Built from
a copy of the packages in a temporary directory, offline (``--no-index``,
``--no-build-isolation``), so the checkout gains no build output."""

import glob
import os
import shutil
import subprocess
import sys
import zipfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_wheel_ships_the_port_sources(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(os.path.join(REPO, "pyproject.toml"), src)
    for pkg in ("hydragnn_tpu", "hydragnn_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = tmp_path / "wheels"
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
                    "--no-index", "-q", "-w", str(out), str(src)], check=True, timeout=300)
    (wheel,) = glob.glob(str(out / "*.whl"))
    names = set(zipfile.ZipFile(wheel).namelist())
    want = {f"hydragnn_tpu_torch/{p}" for p in (
        "csrc/cell_list.cu", "csrc/fp8_matmul.cu", "csrc/quant_matmul.cu",
        "csrc/segment_reduce.cu", "csrc/segment_softmax.cu", "csrc/quant_mma.cuh",
        "native/radius_graph.cpp")}
    on_disk = {os.path.relpath(p, REPO) for pattern in ("csrc/*.cu", "csrc/*.cuh", "native/*.cpp")
               for p in glob.glob(os.path.join(REPO, "hydragnn_tpu_torch", pattern))}
    assert want == on_disk, on_disk
    assert want <= names, sorted(want - names)
