"""Checkpoints, best-model checkpointing and early stopping.

Counterpart of ``hydragnn_tpu/train/checkpoint.py`` with the port's own
format: one ``torch.save`` file per epoch holding the model's state dict
(parameters and running statistics), the optimizer's state dict (moments,
step counts, learning rate) and the step counter, under
``<path>/<log_name>/checkpoints/``:

* ``epoch_<N>.pt`` is written to a temporary name and renamed;
* ``epoch_<N>.pt.manifest.json`` lists every tensor with its shape, dtype
  and CRC32, so a torn write is detected when the checkpoint is read back;
* ``epoch_<N>.meta.json`` holds the caller's metadata (epoch, val loss);
* ``latest`` is a symlink swapped in atomically (symlink to a temporary
  name, then ``os.replace``).

``load_checkpoint`` restores what ``latest`` names and, when that is missing
or fails its manifest, falls back through older epochs, newest first.
Loading the JAX package's orbax checkpoints is not part of this format.
"""

from __future__ import annotations

import json
import os
import warnings
import zlib

import numpy as np
import torch


class CheckpointCorruptError(RuntimeError):
    """A checkpoint whose tensors do not match its manifest (a torn write)."""


def checkpoint_dir(log_name: str, path: str = "./logs/") -> str:
    return os.path.abspath(os.path.join(path, log_name, "checkpoints"))


def _write_json_atomic(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _atomic_symlink(target: str, link: str) -> None:
    """Repoint ``link`` at ``target`` with no moment at which it is missing."""
    tmp = f"{link}.tmp{os.getpid()}"
    if os.path.islink(tmp) or os.path.exists(tmp):
        os.remove(tmp)
    os.symlink(target, tmp)
    os.replace(tmp, link)


def _payload(state) -> dict:
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
    }


def _tensors(payload: dict):
    """(path, tensor) for every tensor of a payload, in a fixed order."""
    for name, t in payload["model"].items():
        yield f"model/{name}", t
    for pid, per_param in sorted(payload["optimizer"]["state"].items()):
        for key, t in sorted(per_param.items()):
            if torch.is_tensor(t):
                yield f"optimizer/{pid}/{key}", t


def _crc(t: torch.Tensor) -> int:
    raw = t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy()
    return zlib.crc32(np.ascontiguousarray(raw)) & 0xFFFFFFFF


def _manifest(payload: dict) -> dict:
    return {
        "step": payload["step"],
        "leaves": [
            {"path": p, "shape": list(t.shape), "dtype": str(t.dtype), "crc32": _crc(t)}
            for p, t in _tensors(payload)
        ],
    }


def save_checkpoint(state, log_name: str, epoch: int, path: str = "./logs/",
                    meta: dict | None = None) -> str:
    """Write ``epoch_<epoch>.pt`` with its manifest and metadata, then point
    ``latest`` at it. Write order is the recovery order: a crash at any
    point leaves the previous ``latest`` loadable."""
    base = checkpoint_dir(log_name, path)
    os.makedirs(base, exist_ok=True)
    name = f"epoch_{epoch}.pt"
    ckpt_path = os.path.join(base, name)
    payload = _payload(state)
    tmp = f"{ckpt_path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, ckpt_path)
    _write_json_atomic(ckpt_path + ".manifest.json", _manifest(payload))
    _write_json_atomic(os.path.join(base, f"epoch_{epoch}.meta.json"),
                       {"epoch": epoch, **(meta or {})})
    _atomic_symlink(name, os.path.join(base, "latest"))
    return ckpt_path


def _epoch_candidates(base: str) -> list[str]:
    """Epoch checkpoint files under ``base``, newest epoch first."""
    out = []
    try:
        names = os.listdir(base)
    except OSError:
        return []
    for name in names:
        if not (name.startswith("epoch_") and name.endswith(".pt")):
            continue
        try:
            out.append((int(name[len("epoch_"):-len(".pt")]), os.path.join(base, name)))
        except ValueError:
            continue
    return [p for _, p in sorted(out, reverse=True)]


def _read_one(ckpt_path: str, device) -> tuple[dict, dict]:
    """The payload, checked against the manifest written beside it, and the
    metadata."""
    payload = torch.load(ckpt_path, map_location=device, weights_only=True)
    with open(ckpt_path + ".manifest.json") as f:
        if _manifest(payload) != json.load(f):
            raise CheckpointCorruptError(f"{ckpt_path}: tensors do not match the manifest")
    meta_file = ckpt_path[: -len(".pt")] + ".meta.json"
    meta = {}
    if os.path.exists(meta_file):
        with open(meta_file) as f:
            meta = json.load(f)
    return payload, meta


def load_checkpoint(state, log_name: str, path: str = "./logs/",
                    epoch: int | None = None) -> dict:
    """Restore a checkpoint into ``state`` (its model, optimizer and step,
    on the model's device) and return its metadata.

    ``epoch=None`` reads what ``latest`` names and, when that is missing or
    corrupt, older epochs, newest first; an explicit ``epoch`` reads exactly
    that one. Raises ``FileNotFoundError`` naming the run directory when
    nothing there is loadable."""
    base = checkpoint_dir(log_name, path)
    fallback = epoch is None
    if not fallback:
        candidates = [os.path.join(base, f"epoch_{epoch}.pt")]
    else:
        latest = os.path.join(base, "latest")
        candidates = [os.path.realpath(latest)] if os.path.islink(latest) else []
        candidates += [c for c in _epoch_candidates(base)
                       if os.path.realpath(c) not in candidates]
    device = next(state.model.parameters()).device
    errors = []
    for i, cand in enumerate(candidates):
        try:
            payload, meta = _read_one(cand, device)
        except (OSError, CheckpointCorruptError, RuntimeError, ValueError) as e:
            if not fallback:
                raise
            errors.append(f"{os.path.basename(cand)}: {type(e).__name__}: {e}")
            continue
        if i > 0 and errors:
            warnings.warn(f"checkpoint fallback: restored {os.path.basename(cand)} after "
                          f"newer candidate(s) failed ({'; '.join(errors)})")
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return meta
    detail = f" (candidates failed: {'; '.join(errors)})" if errors else ""
    raise FileNotFoundError(
        f"no loadable checkpoint under {os.path.dirname(base)} — expected a 'latest' "
        f"pointer or epoch_<N>.pt files in {base}{detail}"
    )


class Checkpoint:
    """Save on a new best validation loss, after ``warmup`` epochs."""

    def __init__(self, log_name: str, warmup: int = 0, path: str = "./logs/"):
        self.log_name = log_name
        self.warmup = warmup
        self.path = path
        self.best = float("inf")

    def __call__(self, state, epoch: int, val_loss: float) -> bool:
        # a non-finite loss is never an improvement
        if epoch < self.warmup or not np.isfinite(val_loss) or val_loss >= self.best:
            return False
        self.best = val_loss
        save_checkpoint(state, self.log_name, epoch, self.path, meta={"val_loss": val_loss})
        return True


class EarlyStopping:
    """Stop after ``patience`` epochs without a validation loss below the
    best by more than ``min_delta``."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.count = 0
        self.early_stop = False

    def __call__(self, val_loss: float) -> bool:
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.count = 0
        else:
            self.count += 1
            if self.count >= self.patience:
                self.early_stop = True
        return self.early_stop


__all__ = [
    "Checkpoint",
    "CheckpointCorruptError",
    "EarlyStopping",
    "checkpoint_dir",
    "load_checkpoint",
    "save_checkpoint",
]
