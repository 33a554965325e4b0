"""``run_training`` — the training entry point.

Counterpart of ``hydragnn_tpu/run_training.py`` for one process on one
device: the data prologue, the model and its optimizer, optional resume
(``Training.continue`` from the run named by ``Training.startfrom``), the
train loader behind a ``PrefetchLoader`` (``Training.prefetch``, default
2), the epoch loop (``Training.steps_per_dispatch`` train steps per
dispatch; on the card every step a CUDA-graph replay), and a final
checkpoint. Runs on the card unless the
caller passes ``device="cpu"``; checkpoints and the augmented config go
under ``path`` (``<path>/<run name>/``).
"""

from __future__ import annotations

from typing import Sequence

from .config import get_log_name_config, load_config, save_config, update_config
from .graphs.batching import PrefetchLoader
from .models.create import create_model_config
from .preprocess.load_data import dataset_loading_and_splitting
from .train.checkpoint import load_checkpoint, save_checkpoint
from .train.loop import train_validate_test
from .train.step import create_train_state, resolve_precision
from .utils import resolve_device

# config switches of the JAX package's run_training that this slice does not
# run: (section, key, whether the value asks for it, what and its slice)
_LATER = (
    ("Training", "population", bool, "population training (a later slice: run-time extras)"),
    ("Training", "resilience", bool, "the resilience layer: non-finite guard, rollback, "
                                     "preemption (a later slice: run-time extras)"),
    ("Training", "num_workers", lambda v: v not in (None, 0, 1),
     "multi-worker collate (a later slice: data plane)"),
    ("Architecture", "parallelism", lambda v: v not in (None, "data"),
     "mesh parallelism (a later slice: parallelism)"),
    ("Architecture", "edge_sharding", bool, "edge sharding (a later slice: parallelism)"),
    ("Architecture", "halo", lambda v: bool(v) and bool(v.get("enabled")),
     "halo exchange (a later slice: parallelism)"),
)


def _refuse_later_slices(config: dict) -> None:
    nn_cfg = config.get("NeuralNetwork", {})
    for section, key, asks, what in _LATER:
        if asks(nn_cfg.get(section, {}).get(key)):
            raise NotImplementedError(f"{section}.{key}: {what} is not ported yet")
    if config.get("Telemetry"):
        raise NotImplementedError(
            "Telemetry: the telemetry plane is not ported yet (a later slice: run-time extras)"
        )


def run_training(config_source, samples: Sequence | None = None, device="cuda",
                 path: str = "./logs/", seed: int = 0, history: list | None = None):
    """Train the configured model on ``samples`` (in memory), its
    parameters and its dropout masks drawn from ``seed``. Returns ``(state, model, augmented
    config)`` as the JAX package does; ``state`` holds the model, its
    optimizer and the step count. ``history``, when given, receives one dict
    per epoch (losses, learning rate)."""
    device = resolve_device(device)
    config = load_config(config_source)
    _refuse_later_slices(config)
    verbosity = int(config.get("Verbosity", {}).get("level", 0))
    train_loader, val_loader, test_loader = dataset_loading_and_splitting(config, samples=samples)
    config = update_config(config, train_loader.samples, val_loader.samples,
                           test_loader.samples)
    training = config["NeuralNetwork"]["Training"]
    log_name = get_log_name_config(config)
    save_config(config, log_name, path)

    model = create_model_config(config, device=device, seed=seed)
    state = create_train_state(model, training["Optimizer"], seed=seed)
    if training.get("continue"):
        startfrom = training.get("startfrom", log_name)
        meta = load_checkpoint(state, startfrom, path=path)
        if verbosity > 0:
            print(f"resumed from {startfrom} (epoch {meta.get('epoch')})", flush=True)

    depth = int(training.get("prefetch", 2))
    if depth > 0:
        train_loader = PrefetchLoader(train_loader, depth=depth, device=device)
    if config.get("Visualization", {}).get("create_plots"):
        print("Visualization.create_plots: plots are not ported yet (a later slice: run-time "
              "extras; they draw with matplotlib, which the port does not require); training "
              "without them", flush=True)

    train_validate_test(
        state, train_loader, val_loader, test_loader, config["NeuralNetwork"], log_name,
        verbosity, compute_dtype=resolve_precision(str(training["precision"]), device),
        path=path, history=history,
    )
    save_checkpoint(state, log_name, epoch=int(training.get("num_epoch", 0)), path=path,
                    meta={"final": True})
    return state, model, config


__all__ = ["run_training"]
