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

The other optax types of the JAX package have no ``torch.optim`` class that
computes optax's update (torch's RMSprop decays by 0.99 with ``eps``
outside the root, its Adagrad starts at 0 with ``eps`` outside, its
Adadelta defaults to ``lr`` 1, and it has no LAMB), so the port computes
optax's own (``optax`` 0.2.6), one class each, element by element in
optax's order of operations:

* ``RMSprop`` (:class:`OptaxRMSProp`): ``nu = 0.1 g^2 + 0.9 nu``, ``g
  rsqrt(nu + 1e-8)``; no centring, no momentum;
* ``Adagrad`` (:class:`OptaxAdagrad`): ``s = g^2 + s`` from 0.1, ``g
  rsqrt(s + 1e-7)`` where ``s > 0``;
* ``Adadelta`` (:class:`OptaxAdadelta`): rho 0.9, eps 1e-6, scaled by the
  learning rate the JAX package passes;
* ``Adamax`` (:class:`OptaxAdamax`): ``nu = max(|g| + 1e-8, 0.999 nu)``,
  the bias-corrected first moment over ``nu``;
* ``LAMB`` and ``FusedLAMB`` (:class:`OptaxLAMB`): optax's Adam update
  (eps 1e-6), plus ``weight_decay p`` (0 unless the config gives one), times
  the trust ratio ``||p|| / ||u||`` (1 where either norm is 0).

Their state is made when they are constructed, at optax's initial values
(a captured step then finds it; ``capture.preserved`` restores it), their
bias corrections and trust ratios are computed on the parameters' device,
and the learning rate is a float or a 0-d float64 tensor alike: the update
is ``p + (-lr) u`` with ``-lr`` rounded to float32, as optax's injected
rate is.

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

A population (``train/population.py``) steps ``[N, ...]`` stacked
parameters with the same classes, the JAX package's injected
hyperparameters (``inject_hyperparams``) made per member: the learning
rate and the weight decay are ``[N]`` float64 tensors, the step count of
every parameter is ``[N]`` (a reverted member does not advance, so its bias
correction stays its own), and each per-member scalar is computed as the
single state computes its 0-d one and broadcast over its member's slice, so
member ``i``'s update is, element for element, that of a single state with
member ``i``'s hyperparameters. LAMB's trust ratio takes each member's
norms over its own slice.
"""

from __future__ import annotations

import torch

# optax.adamw's signature default
OPTAX_ADAMW_WEIGHT_DECAY = 1e-4
# the decoupled-decay optimizers and their optax signature defaults (the
# JAX package's ``_DECOUPLED_DECAY``)
DECOUPLED_DECAY_DEFAULTS = {"adamw": OPTAX_ADAMW_WEIGHT_DECAY, "lamb": 0.0, "fusedlamb": 0.0}


def _per_member(x, params):
    """``x`` against each of ``params``: a per-member ``[N]`` tensor as one
    ``[N, 1, ...]`` view per stacked parameter (a list, for the foreach
    operations); a float or a 0-d tensor as it is."""
    if torch.is_tensor(x) and x.dim() == 1:
        return [x.view(-1, *([1] * (p.dim() - 1))) for p in params]
    return x


def _step_count(members: int | None, device) -> torch.Tensor:
    """A parameter's float32 step count: 0-d, or ``[N]`` for a population."""
    return torch.zeros(() if members is None else (int(members),), dtype=torch.float32,
                       device=device)


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
                 weight_decay: float | torch.Tensor = 0.0, decoupled: bool = False,
                 members: int | None = None):
        # "capturable" tells torch's load_state_dict to keep the step count
        # on the parameters' device as float32; ``members``: a population's
        # N (``lr`` and a tensor ``weight_decay`` are then [N])
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay, "decoupled": decoupled,
                                  "capturable": True, "members": members})

    def _init(self, group, p) -> None:
        state = self.state[p]
        if not state:
            state["step"] = _step_count(group["members"], p.device)
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def init_state(self) -> None:
        """Make every parameter's state now (it is made at its first step
        otherwise): a population's revert and a capture then find it."""
        for group in self.param_groups:
            for p in group["params"]:
                self._init(group, p)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CapturableAdam takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                self._init(group, p)
            grads = [p.grad for p in params]
            steps = [self.state[p]["step"] for p in params]
            exp_avgs = [self.state[p]["exp_avg"] for p in params]
            exp_avg_sqs = [self.state[p]["exp_avg_sq"] for p in params]
            beta1, beta2 = group["betas"]
            lr, wd = group["lr"], group["weight_decay"]
            torch._foreach_add_(steps, 1)
            if torch.is_tensor(wd) or wd != 0:
                if group["decoupled"]:
                    torch._foreach_mul_(params, _per_member((1 - lr * wd).float(), params))
                else:
                    grads = torch._foreach_add(grads, params, alpha=wd)
            torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
            torch._foreach_mul_(exp_avg_sqs, beta2)
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
            t = steps[0].double()
            step_size = (-(lr / (1 - torch.pow(beta1, t)))).float()
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, _per_member(
                torch.pow(1 - torch.pow(beta2, t), 0.5).float(), params))
            torch._foreach_add_(denom, group["eps"])
            sizes = _per_member(step_size, params)
            torch._foreach_addcmul_(params, torch._foreach_div(exp_avgs, denom),
                                    sizes if isinstance(sizes, list) else [sizes] * len(params))


class CapturableSGD(torch.optim.Optimizer):
    """Plain SGD, ``p - lr g``, with ``lr`` a 0-d float64 tensor on the
    parameters' device (``torch.optim.SGD`` reads a tensor learning rate
    back on the host): ``torch.optim.SGD``'s foreach update (``p +
    (-lr) g``, one fused multiply-add) bit for bit."""

    def __init__(self, params, lr: torch.Tensor, members: int | None = None):
        super().__init__(params, {"lr": lr, "members": members})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CapturableSGD takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                rate = _per_member((-group["lr"]).float(), params)
                torch._foreach_addcmul_(params, [p.grad for p in params],
                                        rate if isinstance(rate, list) else [rate] * len(params))


class _OptaxRule(torch.optim.Optimizer):
    """An optax update rule over ``params``, with its per-parameter state
    (``MOMENTS``: name -> initial value, and the step count when
    ``COUNTED``) made at construction. ``lr`` is a float or a 0-d float64
    tensor on the parameters' device (the card's, which
    :func:`set_learning_rate` writes in place); the update is computed the
    same way for both. Subclasses give :meth:`direction`, the update before
    the learning rate."""

    MOMENTS: dict = {}
    COUNTED = False

    def __init__(self, params, lr, members: int | None = None, **hyper):
        # "capturable" keeps a loaded step count on the parameters' device
        super().__init__(params, {"lr": lr, **hyper, "capturable": True, "members": members})
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                if self.COUNTED:
                    state["step"] = _step_count(members, p.device)
                for name, init in self.MOMENTS.items():
                    state[name] = torch.full_like(p, init, memory_format=torch.preserve_format)

    @staticmethod
    def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
        """optax's ``1 - decay ** count``, in float32 on the device."""
        return 1.0 - torch.pow(decay, count)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            state = {k: [self.state[p][k] for p in params]
                     for k in (*self.MOMENTS, *(("step",) if self.COUNTED else ()))}
            if self.COUNTED:
                torch._foreach_add_(state["step"], 1)
            updates = self.direction(group, params, grads, state)
            rate = group["lr"]
            if not torch.is_tensor(rate):
                rate = torch.tensor(rate, dtype=torch.float64)
            neg = (-rate).to(device=params[0].device, dtype=torch.float32)
            torch._foreach_mul_(updates, _per_member(neg, params))
            torch._foreach_add_(params, updates)

    def direction(self, group, params, grads, state) -> list:
        raise NotImplementedError


def _moment(moments, values, decay: float) -> None:
    """optax's ``update_moment``: ``m = (1 - decay) v + decay m``, in
    place."""
    scaled = torch._foreach_mul(values, 1.0 - decay)
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, scaled)


class OptaxRMSProp(_OptaxRule):
    """``optax.rmsprop`` (decay 0.9, eps 1e-8 inside the root, no centring,
    no momentum)."""

    MOMENTS = {"nu": 0.0}

    def __init__(self, params, lr, decay: float = 0.9, eps: float = 1e-8,
                 members: int | None = None):
        super().__init__(params, lr, members, decay=decay, eps=eps)

    def direction(self, group, params, grads, state):
        _moment(state["nu"], torch._foreach_mul(grads, grads), group["decay"])
        scaling = torch._foreach_add(state["nu"], group["eps"])
        torch._foreach_rsqrt_(scaling)
        torch._foreach_mul_(scaling, grads)
        return scaling


class OptaxAdagrad(_OptaxRule):
    """``optax.adagrad`` (initial accumulator 0.1, eps 1e-7 inside the
    root, 0 where the accumulator is 0)."""

    MOMENTS = {"sum_of_squares": 0.1}

    def __init__(self, params, lr, eps: float = 1e-7, members: int | None = None):
        super().__init__(params, lr, members, eps=eps)

    def direction(self, group, params, grads, state):
        acc = state["sum_of_squares"]
        torch._foreach_add_(acc, torch._foreach_mul(grads, grads))
        inv = torch._foreach_add(acc, group["eps"])
        torch._foreach_rsqrt_(inv)
        out = []
        for a, i, g in zip(acc, inv, grads):
            out.append(torch.where(a > 0, i, torch.zeros_like(i)) * g)
        return out


class OptaxAdadelta(_OptaxRule):
    """``optax.adadelta`` (rho 0.9, eps 1e-6, no weight decay), scaled by
    the learning rate."""

    MOMENTS = {"e_g": 0.0, "e_x": 0.0}

    def __init__(self, params, lr, rho: float = 0.9, eps: float = 1e-6,
                 members: int | None = None):
        super().__init__(params, lr, members, rho=rho, eps=eps)

    def direction(self, group, params, grads, state):
        rho, eps = group["rho"], group["eps"]
        _moment(state["e_g"], torch._foreach_mul(grads, grads), rho)
        num = torch._foreach_add(state["e_x"], eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(state["e_g"], eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        torch._foreach_mul_(num, grads)
        _moment(state["e_x"], torch._foreach_mul(num, num), rho)
        return num


class OptaxAdamax(_OptaxRule):
    """``optax.adamax`` (b1 0.9, b2 0.999, eps 1e-8): ``nu = max(|g| + eps,
    b2 nu)``, the update ``mu / (1 - b1^t) / nu``."""

    MOMENTS = {"mu": 0.0, "nu": 0.0}
    COUNTED = True

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 members: int | None = None):
        super().__init__(params, lr, members, b1=b1, b2=b2, eps=eps)

    def direction(self, group, params, grads, state):
        b1, b2 = group["b1"], group["b2"]
        _moment(state["mu"], grads, b1)
        inf = torch._foreach_abs(grads)
        torch._foreach_add_(inf, group["eps"])
        torch._foreach_mul_(state["nu"], b2)
        torch._foreach_maximum_(state["nu"], inf)
        out = torch._foreach_div(state["mu"], _per_member(
            self._bias_correction(b1, state["step"][0]), params))
        torch._foreach_div_(out, state["nu"])
        return out


class OptaxLAMB(_OptaxRule):
    """``optax.lamb`` (b1 0.9, b2 0.999, eps 1e-6, eps_root 0): the Adam
    direction, plus ``weight_decay p``, times the per-parameter trust ratio
    ``||p|| / ||u||`` (1 where either norm is 0)."""

    MOMENTS = {"mu": 0.0, "nu": 0.0}
    COUNTED = True

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float | torch.Tensor = 0.0, members: int | None = None):
        super().__init__(params, lr, members, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    def direction(self, group, params, grads, state):
        b1, b2 = group["b1"], group["b2"]
        _moment(state["mu"], grads, b1)
        _moment(state["nu"], torch._foreach_mul(grads, grads), b2)
        count = state["step"][0]
        mu_hat = torch._foreach_div(state["mu"],
                                    _per_member(self._bias_correction(b1, count), params))
        nu_hat = torch._foreach_div(state["nu"],
                                    _per_member(self._bias_correction(b2, count), params))
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, group["eps"])
        torch._foreach_div_(mu_hat, nu_hat)
        wd = group["weight_decay"]
        if torch.is_tensor(wd):
            wd = wd.to(device=params[0].device, dtype=torch.float32)
        torch._foreach_add_(mu_hat, torch._foreach_mul(params, _per_member(wd, params)))
        n = group["members"]
        if n is None:
            p_norm = torch.stack(torch._foreach_norm(params))
            u_norm = torch.stack(torch._foreach_norm(mu_hat))
        else:
            # each member's norms over its own slice, as its single state's
            p_norm = torch.stack(torch._foreach_norm([p[i] for p in params for i in range(n)]))
            u_norm = torch.stack(torch._foreach_norm([u[i] for u in mu_hat for i in range(n)]))
            p_norm, u_norm = p_norm.view(len(params), n), u_norm.view(len(params), n)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                            p_norm / u_norm)
        if n is None:
            torch._foreach_mul_(mu_hat, list(ratio.unbind()))
        else:
            torch._foreach_mul_(mu_hat, [r.view(-1, *([1] * (u.dim() - 1)))
                                         for r, u in zip(ratio.unbind(), mu_hat)])
        return mu_hat


def ensure_injected_weight_decay(optimizer_config: dict) -> dict:
    """Fill an explicit ``weight_decay`` (the optimizer's optax default) when
    the config leaves it implicit: what per-member population decays need,
    as in the JAX package. Raises for an optimizer without a decoupled-decay
    term. Mutates and returns ``optimizer_config``."""
    if optimizer_config.get("weight_decay") is None:
        t = str(optimizer_config.get("type", "AdamW")).lower()
        if t not in DECOUPLED_DECAY_DEFAULTS:
            raise ValueError("per-member weight decays require a decoupled-decay optimizer "
                             f"(one of {sorted(DECOUPLED_DECAY_DEFAULTS)}), got "
                             f"{optimizer_config.get('type')!r}")
        optimizer_config["weight_decay"] = DECOUPLED_DECAY_DEFAULTS[t]
    return optimizer_config


def select_optimizer(optimizer_config: dict, params, capturable: bool | None = None,
                     learning_rates=None, weight_decays=None) -> torch.optim.Optimizer:
    """The ``Training.Optimizer`` section as a ``torch.optim`` optimizer
    over ``params``: capturable, with a device learning rate, when they lie
    on the card (``capturable`` True: on the CPU too, the card's update
    computed there).

    ``learning_rates`` (and optionally ``weight_decays``): one value per
    member of a population whose ``params`` are ``[N, ...]`` stacks; the
    optimizer is then the capturable class on any device, with ``[N]``
    float64 rates and decays on the parameters' device."""
    params = list(params)
    lr = float(optimizer_config["learning_rate"])
    opt_type = str(optimizer_config.get("type", "AdamW"))
    t = opt_type.lower()
    device = params[0].device
    members = None if learning_rates is None else len(learning_rates)
    card = (bool(params) and params[0].is_cuda) if capturable is None else bool(capturable)
    card = card or members is not None
    if members is not None:
        rate = torch.tensor([float(x) for x in learning_rates], dtype=torch.float64,
                            device=device)
    else:
        rate = torch.full((), lr, dtype=torch.float64, device=device) if card else lr
    wd = optimizer_config.get("weight_decay")
    if weight_decays is not None:
        if t not in DECOUPLED_DECAY_DEFAULTS:
            raise ValueError(f"per-member weight decays need a decoupled-decay optimizer, not "
                             f"{opt_type!r}")
        if len(weight_decays) != members:
            raise ValueError(f"got {len(weight_decays)} weight decays for {members} members")
        wd = torch.tensor([float(x) for x in weight_decays], dtype=torch.float64, device=device)
    if t == "adamw":
        wd = OPTAX_ADAMW_WEIGHT_DECAY if wd is None else wd
        wd = wd if torch.is_tensor(wd) else float(wd)
        if card:
            return CapturableAdam(params, rate, weight_decay=wd, decoupled=True,
                                  members=members)
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if t == "adam":
        if card:
            return CapturableAdam(params, rate, members=members)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    if t == "sgd":
        return CapturableSGD(params, lr=rate, members=members) if card else \
            torch.optim.SGD(params, lr=lr)
    if t in ("lamb", "fusedlamb"):
        wd = 0.0 if wd is None else wd
        return OptaxLAMB(params, rate, weight_decay=wd if torch.is_tensor(wd) else float(wd),
                         members=members)
    if t in _OPTAX_RULES:
        return _OPTAX_RULES[t](params, rate, members=members)
    raise NameError(f"The string used to identify the optimizer is NOT recognized: {opt_type}")


_OPTAX_RULES = {"rmsprop": OptaxRMSProp, "adagrad": OptaxAdagrad, "adadelta": OptaxAdadelta,
                "adamax": OptaxAdamax}


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
            saved = dict(group)
            group.clear()
            group.update(own)
            rate = own["lr"]
            if not torch.is_tensor(rate):
                group["lr"] = float(saved["lr"])
            # device hyperparameters (the rate; a population's per-member
            # rates and decays) take the saved values in place
            for key, value in own.items():
                if torch.is_tensor(value) and key in saved:
                    value.copy_(torch.as_tensor(saved[key], dtype=value.dtype))
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
    "DECOUPLED_DECAY_DEFAULTS",
    "OPTAX_ADAMW_WEIGHT_DECAY",
    "CapturableAdam",
    "CapturableSGD",
    "OptaxAdadelta",
    "OptaxAdagrad",
    "OptaxAdamax",
    "OptaxLAMB",
    "OptaxRMSProp",
    "ReduceLROnPlateau",
    "ensure_injected_weight_decay",
    "get_learning_rate",
    "load_optimizer_state",
    "select_optimizer",
    "set_learning_rate",
]
