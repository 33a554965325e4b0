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
scheduler changes it between steps. On the CPU the optimizers are the
``torch.optim`` ones with a float learning rate. On the card their steps
must be captured in CUDA graphs (``capture.py``), which take no scalar from
the host at replay: :class:`CapturableAdam` and :class:`CapturableSGD` keep
the learning rate as a 0-d float64 tensor on the parameters' device, which
:func:`set_learning_rate` writes in place, and the step count there too.
They compute ``torch.optim``'s own update on the card bit for bit (its
foreach route), so a captured run trains the model an eager run of
``torch.optim`` trains; ``torch.optim.AdamW(capturable=True)`` does not (it
takes the bias corrections in float32 on the card, where the foreach route
takes them in double precision on the host).
"""

from __future__ import annotations

import torch

# optax.adamw's signature default
OPTAX_ADAMW_WEIGHT_DECAY = 1e-4


class CapturableAdam(torch.optim.Optimizer):
    """Adam, or AdamW with ``decoupled=True``, with ``lr`` a 0-d float64
    tensor on the parameters' device and a float32 step count there per
    parameter (``torch.optim.Adam``'s state, keys and types), so that a step
    can be captured. The update is ``torch.optim.Adam``/``AdamW``'s foreach
    route (not capturable) on the card, bit for bit: the scalars it computes
    on the host in double precision (``1 - lr wd``, ``-lr / (1 -
    beta1^t)``, ``(1 - beta2^t)^0.5``) are computed in float64 here and
    rounded to float32 where the foreach kernels round them, every
    per-element operation is the same foreach operation, and its last,
    ``p + step_size * (m / d)`` (an ``addcdiv`` by a host scalar there), is
    the quotient, then ``_foreach_addcmul_`` by the 0-d step size: the same
    fused multiply-add, in fewer launches than an ``addcmul_`` per
    parameter. A group's parameters step together (every train step
    gives each one a gradient), so its first step count serves them all."""

    def __init__(self, params, lr: torch.Tensor, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = False):
        # "capturable" tells torch's load_state_dict to keep the step count
        # on the parameters' device as float32
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay, "decoupled": decoupled,
                                  "capturable": True})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CapturableAdam takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p,
                                                           memory_format=torch.preserve_format)
            grads = [p.grad for p in params]
            steps = [self.state[p]["step"] for p in params]
            exp_avgs = [self.state[p]["exp_avg"] for p in params]
            exp_avg_sqs = [self.state[p]["exp_avg_sq"] for p in params]
            beta1, beta2 = group["betas"]
            lr, wd = group["lr"], group["weight_decay"]
            torch._foreach_add_(steps, 1)
            if wd != 0:
                if group["decoupled"]:
                    torch._foreach_mul_(params, (1 - lr * wd).float())
                else:
                    grads = torch._foreach_add(grads, params, alpha=wd)
            torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
            torch._foreach_mul_(exp_avg_sqs, beta2)
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
            t = steps[0].double()
            step_size = (-(lr / (1 - torch.pow(beta1, t)))).float()
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, torch.pow(1 - torch.pow(beta2, t), 0.5).float())
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_addcmul_(params, torch._foreach_div(exp_avgs, denom),
                                    [step_size] * len(params))


class CapturableSGD(torch.optim.Optimizer):
    """Plain SGD, ``p - lr g``, with ``lr`` a 0-d float64 tensor on the
    parameters' device (``torch.optim.SGD`` reads a tensor learning rate
    back on the host): ``torch.optim.SGD``'s foreach update (``p +
    (-lr) g``, one fused multiply-add) bit for bit."""

    def __init__(self, params, lr: torch.Tensor):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CapturableSGD takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                torch._foreach_addcmul_(params, [p.grad for p in params],
                                        [(-group["lr"]).float()] * len(params))


def select_optimizer(optimizer_config: dict, params) -> torch.optim.Optimizer:
    """The ``Training.Optimizer`` section as a ``torch.optim`` optimizer
    over ``params``: capturable, with a device learning rate, when they lie
    on the card."""
    params = list(params)
    lr = float(optimizer_config["learning_rate"])
    opt_type = str(optimizer_config.get("type", "AdamW"))
    t = opt_type.lower()
    card = bool(params) and params[0].is_cuda
    rate = torch.full((), lr, dtype=torch.float64, device=params[0].device) if card else lr
    if t == "adamw":
        wd = optimizer_config.get("weight_decay")
        wd = OPTAX_ADAMW_WEIGHT_DECAY if wd is None else float(wd)
        if card:
            return CapturableAdam(params, rate, weight_decay=wd, decoupled=True)
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if t == "adam":
        if card:
            return CapturableAdam(params, rate)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    if t == "sgd":
        return CapturableSGD(params, lr=rate) if card else torch.optim.SGD(params, lr=lr)
    if t in ("rmsprop", "adagrad", "adadelta", "adamax", "lamb", "fusedlamb"):
        raise NotImplementedError(
            f"optimizer {opt_type!r} is not ported yet: optax's defaults for it differ "
            "from torch's; it comes with a later slice"
        )
    raise NameError(f"The string used to identify the optimizer is NOT recognized: {opt_type}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's rate; a device rate is written in place, where the
    captured steps read it."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: dict) -> None:
    """``optimizer.load_state_dict`` that keeps what a captured step holds
    and the optimizer's own kind: the groups keep their hyperparameters and
    take the saved learning rate (written into a device rate in place, read
    as a float by an optimizer that keeps floats), loaded state is copied
    into the state tensors that exist already, and the rest is moved to its
    parameter's device (a checkpoint of the CPU's ``torch.optim`` optimizer
    restores into the card's capturable one, and back)."""
    mine = [dict(g) for g in optimizer.param_groups]
    held = {id(p): dict(s) for p, s in optimizer.state.items()}
    optimizer.load_state_dict(state_dict)
    with torch.no_grad():
        for group, own in zip(optimizer.param_groups, mine):
            saved, rate = group["lr"], own["lr"]
            group.clear()
            group.update(own)
            if torch.is_tensor(rate):
                rate.copy_(torch.as_tensor(saved, dtype=rate.dtype))
            else:
                group["lr"] = float(saved)
        for p, s in optimizer.state.items():
            old = held.get(id(p), {})
            for k, v in s.items():
                if not torch.is_tensor(v):
                    continue
                prev = old.get(k)
                if torch.is_tensor(prev) and prev.shape == v.shape:
                    prev.copy_(v)
                    s[k] = prev
                elif v.device != p.device:
                    s[k] = v.to(p.device)


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
    "CapturableAdam",
    "CapturableSGD",
    "ReduceLROnPlateau",
    "get_learning_rate",
    "load_optimizer_state",
    "select_optimizer",
    "set_learning_rate",
]
