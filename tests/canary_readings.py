"""Print the BCC convergence canaries' readings of the JAX package and of
the port (on the CPU) for the given conv stacks, one JSON line each:

    JAX_PLATFORMS=cpu python tests/canary_readings.py SAGE MFC SchNet PNA PNAPlus CGCNN
    JAX_PLATFORMS=cpu python tests/canary_readings.py gat_edge gps_pna_edge gps_performer
    JAX_PLATFORMS=cpu python tests/canary_readings.py gin_per_node gin_conv_heads

A stack's configuration is ``tests/test_training_e2e.py::test_invariant_arch_convergence``'s
(``run_arch_e2e`` with ``multihead=True`` and the stack's ``ARCH_OVERRIDES``:
4 heads, batch 16, lr 0.01, 100 epochs, 500 samples of seed 7), and each
line holds every head's RMSE and sample MAE beside the stack's
``THRESHOLDS``. A lower-case name is one of ``chip_smoke.CANARIES``
(``chip_smoke.canary_config``: its samples, data seed, epochs and
thresholds; GAT with the edge lengths, GPS-PNA with the edge lengths, the
GPS performer; the 4-head GIN with ``mlp_per_node`` node heads, on the
fixed-size graphs of ``chip_smoke.CANARY_DATA``, and with ``conv`` node
heads). The tests gate these numbers; this script only reads them.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# one device, as the tests pin it (tests/conftest.py)
os.environ.setdefault("HYDRAGNN_AUTO_PARALLEL", "0")
sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import numpy as np  # noqa: E402


def readings(trues, preds) -> tuple[list, list]:
    rmse = [float(np.sqrt(np.mean((t - p) ** 2))) for t, p in zip(trues, preds)]
    mae = [float(np.mean(np.abs(t - p))) for t, p in zip(trues, preds)]
    return rmse, mae


def jax_canary(cfg, n: int = 500, seed: int = 7, **data) -> tuple[list, list]:
    import hydragnn_tpu
    from hydragnn_tpu.datasets import deterministic_graph_data

    # fresh samples for each call: preprocessing mutates them (the edge
    # lengths are appended)
    state, model, _ = hydragnn_tpu.run_training(
        copy.deepcopy(cfg),
        samples=deterministic_graph_data(number_configurations=n, seed=seed, **data))
    _, _, trues, preds = hydragnn_tpu.run_prediction(
        copy.deepcopy(cfg), state, model,
        samples=deterministic_graph_data(number_configurations=n, seed=seed, **data))
    return readings(trues, preds)


def port_canary(cfg, n: int = 500, seed: int = 7, **data) -> tuple[list, list]:
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.datasets import deterministic_graph_data

    with tempfile.TemporaryDirectory() as tmp:
        state, _, _ = run_training(copy.deepcopy(cfg), device="cpu", path=tmp,
                                   samples=deterministic_graph_data(n, seed=seed, **data))
    _, _, trues, preds = run_prediction(copy.deepcopy(cfg), state, device="cpu",
                                        samples=deterministic_graph_data(n, seed=seed, **data))
    return readings(trues, preds)


def chip_smoke_canary(name: str) -> None:
    """One of ``chip_smoke.CANARIES`` in both packages, its held heads
    beside its thresholds."""
    import chip_smoke

    n, seed, _, rmse_max, mae_max, held = chip_smoke.CANARIES[name]
    cfg = chip_smoke.canary_config(name)
    data = chip_smoke.CANARY_DATA.get(name, {})
    for package, fn in (("hydragnn_tpu", jax_canary), ("hydragnn_tpu_torch (cpu)",
                                                        port_canary)):
        t0 = time.perf_counter()
        rmse, mae = fn(cfg, n, seed, **data)
        print(json.dumps({"canary": name, "package": package, "rmse": rmse[:held],
                          "mae": mae[:held], "thresholds": [rmse_max, mae_max],
                          "seconds": time.perf_counter() - t0}), flush=True)


def main(stacks) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(1)
    from test_torch_invariant_train import stack_config
    from test_training_e2e import THRESHOLDS

    for stack in stacks:
        if stack.islower():
            chip_smoke_canary(stack)
            continue
        cfg = stack_config(stack)
        cfg["NeuralNetwork"]["Training"]["num_epoch"] = 100
        for package, fn in (("hydragnn_tpu", jax_canary), ("hydragnn_tpu_torch (cpu)",
                                                            port_canary)):
            t0 = time.perf_counter()
            rmse, mae = fn(cfg)
            print(json.dumps({"stack": stack, "package": package, "rmse": rmse, "mae": mae,
                              "thresholds": THRESHOLDS[stack],
                              "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["SAGE", "MFC", "SchNet", "PNA", "PNAPlus", "CGCNN"])
