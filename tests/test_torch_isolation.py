"""The PyTorch port stands alone: ``hydragnn_tpu_torch`` and ``chip_smoke.py``
import neither JAX (nor flax/optax) nor anything of the JAX package, and a
CPU forward pass, the data plane's modules (a packed store written and
loaded), the tensor-parallel and pipeline modules and the resilience layer
leave both out of ``sys.modules``."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "hydragnn_tpu")


def _port_sources():
    return sorted((ROOT / "hydragnn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    for lineno, mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)}:{lineno} imports {mod}"


_PROBE = r"""
import json, sys
import numpy as np
import torch
import hydragnn_tpu_torch as h
from hydragnn_tpu_torch.config import update_config
from hydragnn_tpu_torch.graphs.batching import collate, compute_pad_spec
from hydragnn_tpu_torch.graphs.graph import GraphSample
from hydragnn_tpu_torch.graphs.radius import radius_graph
from hydragnn_tpu_torch.serve import Predictor

rng = np.random.default_rng(0)
samples = []
for _ in range(4):
    pos = rng.uniform(0, 4.0, size=(10, 3))
    s, r, sh = radius_graph(pos, 3.0, max_neighbours=20)
    samples.append(GraphSample(x=rng.integers(1, 10, size=(10, 1)), pos=pos, senders=s,
                               receivers=r, edge_shifts=sh, graph_y=rng.normal(size=1)))
cfg = h.load_config(sys.argv[1])
cfg["Dataset"] = {"name": "probe", "node_features": cfg["Dataset"]["node_features"],
                  "graph_features": cfg["Dataset"]["graph_features"]}
aug = update_config(cfg, samples)
model = h.create_model_config(aug, device="cpu")
out = Predictor(model, aug, device="cpu").outputs(collate(samples, compute_pad_spec(samples, 4)))
# the data plane: readers, the packed store, the sharded store, the native
# helpers and the pre/post-processing modules
import tempfile
from hydragnn_tpu_torch import native, postprocess  # noqa: F401
from hydragnn_tpu_torch.datasets import convert, hdf5, sharded  # noqa: F401
from hydragnn_tpu_torch.datasets.packed import GlobalShuffleStore, PackedWriter
from hydragnn_tpu_torch.preprocess import descriptors, energy_linear_regression  # noqa: F401
from hydragnn_tpu_torch.preprocess import molgraph  # noqa: F401
with tempfile.TemporaryDirectory() as d:
    PackedWriter(samples, d + "/s.gpk")
    assert len(list(GlobalShuffleStore(d + "/s.gpk").loader(2))) == 2
# tensor and pipeline parallelism, the resilience layer and the walltime guard
from hydragnn_tpu_torch.parallel import pipeline, tensor  # noqa: F401
from hydragnn_tpu_torch.resilience import campaign, chaos, elastic, guard  # noqa: F401
from hydragnn_tpu_torch.resilience import preempt, watchdog  # noqa: F401
from hydragnn_tpu_torch.utils import walltime  # noqa: F401
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "hydragnn_tpu"))
print(json.dumps({"bad": bad, "shape": list(out[0].shape),
                  "finite": bool(torch.isfinite(out[0]).all())}))
"""


def test_import_and_cpu_forward_leave_jax_unloaded():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "examples" / "qm9" / "qm9.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], f"loaded: {res['bad']}"
    assert res["shape"] == [5, 1] and res["finite"]


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line when no
    CUDA device is present, and also when it is alone in a directory."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
