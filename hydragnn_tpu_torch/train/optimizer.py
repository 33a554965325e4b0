"""Optimizer selection and the plateau learning-rate schedule.

Counterpart of ``hydragnn_tpu/train/optimizer.py``. The JAX package builds
optax optimizers; the port builds the ``torch.optim`` optimizers that compute
the same update, with optax's defaults passed explicitly where torch's
differ:

* ``AdamW``: optax's default ``weight_decay`` is 1e-4 (torch's is 1e-2).
  Both decay every parameter (biases, norm scales and GIN's ``eps``
  included) by ``lr * weight_decay * p`` next to the Adam step, and put
  ``eps`` and the bias correction in the same places;
* ``Adam``: no weight decay, ``eps`` 1e-8, betas (0.9, 0.999) on both;
* ``SGD``: plain ``p -= lr * g``, no momentum.

The other optax types of the JAX package (rmsprop, adagrad, adadelta,
adamax, lamb) raise until each has its own parity test: optax's defaults
differ from torch's for some of them (rmsprop's ``decay`` 0.9 against
torch's ``alpha`` 0.99, with ``eps`` inside the square root; adagrad's
initial accumulator 0.1 and ``eps`` 1e-7), and lamb has no ``torch.optim``
counterpart.

The learning rate lives in ``param_groups``, so the host-side plateau
scheduler changes it between steps.
"""

from __future__ import annotations

import torch

# optax.adamw's signature default
OPTAX_ADAMW_WEIGHT_DECAY = 1e-4


def select_optimizer(optimizer_config: dict, params) -> torch.optim.Optimizer:
    """The ``Training.Optimizer`` section as a ``torch.optim`` optimizer
    over ``params``."""
    lr = float(optimizer_config["learning_rate"])
    opt_type = str(optimizer_config.get("type", "AdamW"))
    t = opt_type.lower()
    if t == "adamw":
        wd = optimizer_config.get("weight_decay")
        wd = OPTAX_ADAMW_WEIGHT_DECAY if wd is None else float(wd)
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=wd)
    if t == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    if t == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if t in ("rmsprop", "adagrad", "adadelta", "adamax", "lamb", "fusedlamb"):
        raise NotImplementedError(
            f"optimizer {opt_type!r} is not ported yet: optax's defaults for it differ "
            "from torch's; it comes with a later slice"
        )
    raise NameError(f"The string used to identify the optimizer is NOT recognized: {opt_type}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class ReduceLROnPlateau:
    """The JAX package's host-side plateau schedule, as it is (mode 'min',
    factor 0.5, patience 5, min_lr 1e-5, relative threshold 1e-4). Not
    ``torch.optim.lr_scheduler.ReduceLROnPlateau``, whose threshold and eps
    rules differ."""

    def __init__(
        self,
        init_lr: float,
        mode: str = "min",
        factor: float = 0.5,
        patience: int = 5,
        min_lr: float = 1e-5,
        threshold: float = 1e-4,
    ):
        if mode != "min":
            raise ValueError(f"ReduceLROnPlateau supports mode='min' only, got {mode!r}")
        self.lr = float(init_lr)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        """Feed a validation metric; returns the (possibly decayed) LR."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]


__all__ = [
    "OPTAX_ADAMW_WEIGHT_DECAY",
    "ReduceLROnPlateau",
    "get_learning_rate",
    "select_optimizer",
    "set_learning_rate",
]
