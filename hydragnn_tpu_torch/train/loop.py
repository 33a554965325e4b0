"""The epoch loop: train, validate, test.

Counterpart of ``hydragnn_tpu/train/loop.py`` on one device with one step
per dispatch (K = 1): per epoch the train loader reshuffles
(``set_epoch``), the train metrics are reduced weighted by graph count, the
validation and test splits are evaluated, the plateau scheduler steps on the
validation loss, then the best-model checkpoint and early stopping run. A
split's per-head RMSE is one square root of its summed squared errors.

The step metrics stay on the device until the epoch ends and come to the
host in one transfer. Not in this slice (they raise ``NotImplementedError``
in ``run_training``): supersteps, populations, meshes, halo exchange, edge
sharding, the resilience layer (non-finite guard, rollback, preemption),
telemetry and the compile cache.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .checkpoint import Checkpoint, EarlyStopping
from .optimizer import ReduceLROnPlateau, get_learning_rate, set_learning_rate
from .step import TrainState, make_eval_step, make_train_step, resolve_loss_scale


def _log(verbosity: int, msg: str) -> None:
    if verbosity > 0:
        print(msg, flush=True)


def accumulate(step_metrics: list[dict], extra_keys: tuple = ()):
    """Graph-count-weighted means of an epoch's ``loss`` and ``tasks_loss``
    and the sums of ``extra_keys``, after one device-to-host transfer."""
    if not step_metrics:
        return 0.0, np.zeros(0), {k: None for k in extra_keys}
    keys = ("num_graphs", "loss", "tasks_loss") + tuple(extra_keys)
    host = {k: torch.stack([m[k] for m in step_metrics]).double().cpu().numpy() for k in keys}
    g = host["num_graphs"]
    denom = max(float(g.sum()), 1.0)
    loss = float((host["loss"] * g).sum()) / denom
    tasks = (host["tasks_loss"] * g[:, None]).sum(axis=0) / denom
    return loss, tasks, {k: host[k].sum(axis=0) for k in extra_keys}


def _batches(loader, device):
    for batch in loader:
        yield batch if batch.device == device else batch.to(device)


def train_epoch(train_step, state: TrainState, loader):
    """One epoch of train steps; returns (mean loss, per-task mean losses)."""
    device = next(state.model.parameters()).device
    metrics = [train_step(state, batch) for batch in _batches(loader, device)]
    loss, tasks, _ = accumulate(metrics)
    return loss, tasks


def evaluate(eval_step, state: TrainState, loader):
    """A whole split; returns (loss, per-task losses, per-head RMSE)."""
    device = next(state.model.parameters()).device
    metrics = [eval_step(state, batch) for batch in _batches(loader, device)]
    loss, tasks, extras = accumulate(metrics, extra_keys=("head_sse", "head_count"))
    sse, count = extras["head_sse"], extras["head_count"]
    rmse = np.sqrt(sse / np.maximum(count, 1.0)) if sse is not None else np.zeros(0)
    return loss, tasks, rmse


def test(eval_step, state: TrainState, loader):
    """(total error, per-task losses, per-head RMSE) of the test split."""
    return evaluate(eval_step, state, loader)


def train_validate_test(state: TrainState, train_loader, val_loader, test_loader,
                        config_nn: dict, log_name: str, verbosity: int = 0,
                        compute_dtype: torch.dtype = torch.float32, path: str = "./logs/",
                        start_epoch: int = 0, history: list | None = None) -> TrainState:
    """The epoch loop over epochs ``start_epoch .. Training.num_epoch - 1``
    (a resumed run passes the first epoch it has not trained; the plateau
    schedule and the best-model and early-stopping records start afresh).
    ``history``, when given, receives one dict per epoch (train/val/test
    losses, LR, and the epoch's wall seconds up to the checkpoint)."""
    training = config_nn["Training"]
    num_epoch = int(training["num_epoch"])
    train_step = make_train_step(compute_dtype, resolve_loss_scale(training))
    eval_step = make_eval_step(compute_dtype)
    scheduler = ReduceLROnPlateau(get_learning_rate(state.optimizer))
    checkpoint = (
        Checkpoint(log_name, warmup=int(training.get("checkpoint_warmup", 0)), path=path)
        if training.get("Checkpoint", False) else None
    )
    early_stopping = (
        EarlyStopping(patience=int(training.get("patience", 10)))
        if training.get("EarlyStopping", False) else None
    )
    # a dataset too small (or perc_train = 1) can leave val/test empty
    skip_valtest = len(val_loader.samples) == 0 or len(test_loader.samples) == 0

    for epoch in range(start_epoch, num_epoch):
        t_epoch = time.perf_counter()
        train_loader.set_epoch(epoch)
        train_loss, _ = train_epoch(train_step, state, train_loader)
        record = {"epoch": epoch, "train_loss": train_loss}
        if skip_valtest:
            _log(verbosity, f"Epoch: {epoch:04d}, Train Loss: {train_loss:.8f}")
            if checkpoint is not None:
                checkpoint(state, epoch, train_loss)
            record["seconds"] = time.perf_counter() - t_epoch
            if history is not None:
                history.append(record)
            continue
        val_loss, _, _ = evaluate(eval_step, state, val_loader)
        test_loss, _, _ = evaluate(eval_step, state, test_loader)
        new_lr = scheduler.step(val_loss)
        if new_lr != get_learning_rate(state.optimizer):
            set_learning_rate(state.optimizer, new_lr)
        _log(verbosity, f"Epoch: {epoch:04d}, Train Loss: {train_loss:.8f}, Val Loss: "
                        f"{val_loss:.8f}, Test Loss: {test_loss:.8f}, LR: {new_lr:.2e}")
        record.update(val_loss=val_loss, test_loss=test_loss, lr=new_lr)
        if checkpoint is not None:
            checkpoint(state, epoch, val_loss)
        record["seconds"] = time.perf_counter() - t_epoch
        if history is not None:
            history.append(record)
        if early_stopping is not None and early_stopping(val_loss):
            _log(verbosity, f"Early stopping at epoch {epoch}")
            break
    return state


__all__ = ["accumulate", "evaluate", "test", "train_epoch", "train_validate_test"]
