"""Population training: N trials or ensemble members in one captured step.

Counterpart of ``hydragnn_tpu/train/population.py``. Hyperparameter searches
and deep ensembles train N models that share every shape and differ only
in scalars and initial weights. The JAX package stacks their states along a
leading member axis and ``jax.vmap``s the train step over it; the port does
the same with PyTorch's functional transforms:

* one model module, whose every parameter and buffer is an ``[N, ...]``
  stack of the members' (:class:`PopulationState`; its ``state_dict`` has
  the single model's keys, so the ordinary checkpoint files hold a whole
  population);
* the step is ``torch.func.vmap`` over ``torch.func.functional_call`` of
  that module with one member's slices, the batch shared (``in_dims=(0,
  None)``). The backward of the members' summed loss gives each member its
  own gradient (the sum's gradient with respect to each loss is exactly 1);
* the message-passing kernels fold the member axis into their channels
  (``ops/fused_scatter.py``, ``ops/fused_softmax.py``: each Function's
  ``vmap`` rule), so a population step launches each kernel as often as one
  member's step does, on ``N`` times the channels;
* the optimizer (``train/optimizer.py``) carries ``[N]`` learning rates,
  weight decays and step counts, and gives member ``i`` the update of a
  single state with member ``i``'s hyperparameters;
* the loss weights of :func:`~.step.make_weighted_train_step` are a
  ``[N, n_tasks]`` tensor, one row per member.

On the card the whole population step (forward, backward, optimizer,
revert) is one CUDA graph per bucket (``capture.py``), so one replay
advances N members, and a superstep block of K batches N x K steps.

Per-member divergence: after the step, a member whose loss or new state
(parameters, running statistics, optimizer moments and step counts) is not
finite is put back to its state before the step by a branchless select on
an ``[N]`` mask (the JAX package's ``select_state``), its metrics are
zeroed and ``skipped`` reports it. Healthy members keep the bits they
computed. A member whose skip streak reaches the resilience limit is
reported ``"diverged"`` by :class:`MemberTracker` (read behind the loop's
in-flight window: no host sync per step) and stays frozen at its last
finite state; the others never stall.

Dropout: the members' masks would have to come from N generators inside
the vmapped function. The port refuses a population whose model draws
dropout (rate > 0) rather than give the members shared masks.

The ensemble variance of the summary is the uncertainty signal the bulk
screener (``screen/``) reads per graph.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import time
from collections import deque
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..resilience.guard import state_tensors
from .step import (
    TrainState,
    apply_initial_bias,
    cast_forward,
    freeze_conv_grads,
    head_means,
    resolve_precision,
    weighted_total,
)
from .superstep import make_superstep, resolve_steps_per_dispatch


class PopulationState:
    """N train states stacked along a leading member axis: ``model`` is one
    module whose parameters and buffers are ``[N, ...]`` stacks, and
    ``optimizer`` steps them with per-member hyperparameters. It has a
    ``TrainState``'s attributes (``model``, ``optimizer``, ``step``,
    ``generator`` None, ``layout`` None), so the capture, the epoch loop and
    the checkpoint files take it as they take one state. ``step`` counts
    the population steps taken; ``optimizer_config`` is the run's
    ``Training.Optimizer`` block (a member's own optimizer is rebuilt from
    it)."""

    generator = None
    layout = None
    resilience = None

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 optimizer_config: dict, n_members: int, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.optimizer_config = dict(optimizer_config)
        self.n = int(n_members)
        self.step = int(step)

    @property
    def n_members(self) -> int:
        return self.n

    def hyperparams(self) -> dict:
        """Per-member ``learning_rate`` and ``weight_decay`` lists (floats)."""
        group = self.optimizer.param_groups[0]
        out = {}
        for key, name in (("lr", "learning_rate"), ("weight_decay", "weight_decay")):
            v = group.get(key)
            if torch.is_tensor(v):
                out[name] = [float(x) for x in v.reshape(-1).expand(self.n).tolist()]
            elif v is not None:
                out[name] = [float(v)] * self.n
        return out


def _assign(module: torch.nn.Module, name: str, value: torch.Tensor) -> None:
    """Put ``value`` in place of the parameter or buffer ``name``."""
    owner, _, leaf = name.rpartition(".")
    mod = module.get_submodule(owner) if owner else module
    if leaf in mod._parameters:
        mod._parameters[leaf] = value
    else:
        mod._buffers[leaf] = value


def _stacked_module(models: Sequence[torch.nn.Module]) -> torch.nn.Module:
    """One module with the members' parameters and buffers stacked:
    ``[N, ...]`` each (a parameter shared under two names stays shared)."""
    stack = copy.deepcopy(models[0])
    made: dict = {}
    for name, p in models[0].named_parameters(remove_duplicate=False):
        if id(p) not in made:
            made[id(p)] = torch.nn.Parameter(torch.stack(
                [m.get_parameter(name).detach() for m in models]))
        _assign(stack, name, made[id(p)])
    for name, _ in models[0].named_buffers():
        _assign(stack, name, torch.stack([m.get_buffer(name) for m in models]))
    return stack


def _refuse_dropout(model: torch.nn.Module) -> None:
    from ..models.common import Dropout

    rates = sorted({m.rate for m in model.modules() if isinstance(m, Dropout) and m.rate > 0})
    if rates:
        raise ValueError(
            f"population training: the model draws dropout (rate {rates}); its members' masks "
            "would need one generator each inside the vmapped step. Set "
            "Architecture.dropout to 0 for a population")


def _population_optimizer(optimizer_config: dict, model: torch.nn.Module, n: int,
                          learning_rates=None, weight_decays=None) -> torch.optim.Optimizer:
    """The capturable optimizer over the stacked ``model`` with ``[N]``
    rates and, for a decoupled-decay optimizer, ``[N]`` decays (the
    config's where the per-member values are None), its state made now (so
    a step's revert and a capture find it)."""
    from .optimizer import DECOUPLED_DECAY_DEFAULTS, select_optimizer

    lr = float(optimizer_config["learning_rate"])
    lrs = [lr] * n if learning_rates is None else [float(x) for x in learning_rates]
    t = str(optimizer_config.get("type", "AdamW")).lower()
    if weight_decays is None and t in DECOUPLED_DECAY_DEFAULTS:
        wd = optimizer_config.get("weight_decay")
        weight_decays = [DECOUPLED_DECAY_DEFAULTS[t] if wd is None else float(wd)] * n
    opt = select_optimizer(optimizer_config, model.parameters(), learning_rates=lrs,
                           weight_decays=weight_decays)
    init = getattr(opt, "init_state", None)
    if init is not None:
        init()
    return opt


def stack_states(states: Sequence[TrainState], optimizer_config: dict) -> PopulationState:
    """Stack single train states into one population: parameters, buffers,
    each member's learning rate (and a decoupled-decay optimizer's weight
    decay) from its optimizer, and its optimizer state where it has one."""
    n = len(states)
    model = _stacked_module([s.model for s in states])
    from .optimizer import DECOUPLED_DECAY_DEFAULTS

    groups = [s.optimizer.param_groups[0] for s in states]
    lrs = [float(g["lr"]) for g in groups]
    decoupled = str(optimizer_config.get("type", "AdamW")).lower() in DECOUPLED_DECAY_DEFAULTS
    wds = [float(g["weight_decay"]) for g in groups] if decoupled else None
    opt = _population_optimizer(optimizer_config, model, n, lrs, wds)
    params = list(model.parameters())
    member_params = [list(s.model.parameters()) for s in states]
    for j, p in enumerate(params):
        saved = [s.optimizer.state.get(mp[j], {}) for s, mp in zip(states, member_params)]
        if not all(saved):
            continue
        with torch.no_grad():
            for key, t in opt.state[p].items():
                if torch.is_tensor(t) and all(key in sv for sv in saved):
                    t.copy_(torch.stack([torch.as_tensor(sv[key]).to(t.device).reshape(t.shape[1:])
                                         for sv in saved]))
    return PopulationState(model, opt, optimizer_config, n, step=max(s.step for s in states))


def member_state(pstate: PopulationState, i: int) -> TrainState:
    """Member ``i`` as a single train state of its own (copies): its model,
    and a capturable optimizer with its hyperparameters and state, on the
    population's device."""
    from .optimizer import select_optimizer

    model = copy.deepcopy(pstate.model)
    for name, p in pstate.model.named_parameters(remove_duplicate=False):
        _assign(model, name, torch.nn.Parameter(p[i].detach().clone()))
    for name, b in pstate.model.named_buffers():
        _assign(model, name, b[i].clone())
    hp = pstate.hyperparams()
    cfg = dict(pstate.optimizer_config, learning_rate=hp["learning_rate"][i])
    if "weight_decay" in hp:
        cfg["weight_decay"] = hp["weight_decay"][i]
    opt = select_optimizer(cfg, model.parameters(), capturable=True)
    for p_stack, p in zip(pstate.model.parameters(), model.parameters()):
        st = pstate.optimizer.state.get(p_stack, {})
        if st:
            opt.state[p] = {k: (v[i].clone() if torch.is_tensor(v) else v) for k, v in st.items()}
    return TrainState(model=model, optimizer=opt, step=pstate.step)


def resolve_population_size(training_cfg: dict) -> int:
    """N: ``HYDRAGNN_POPULATION`` overrides ``Training.population.size``;
    unset, 0 or 1 disables."""
    from ..utils import flags

    pop = training_cfg.get("population") or {}
    n = flags.get(flags.POPULATION, default=int(pop.get("size", 0) or 0))
    return max(0, int(n or 0))


def create_population_state(config: dict, n_members: int, seeds: Sequence[int] | None = None,
                            learning_rates: Sequence[float] | None = None,
                            weight_decays: Sequence[float] | None = None,
                            device="cuda") -> PopulationState:
    """Initialise N members from the augmented ``config`` and stack them.
    ``seeds``: each member's parameter seed (deep ensembles); None gives
    every member the seed-0 initialisation a single ``run_training`` starts
    from (HPO trials). ``learning_rates``/``weight_decays``: per-member
    values (None: the ``Training.Optimizer`` block's)."""
    from ..models.create import create_model_config

    n = int(n_members)
    if seeds is not None and len(seeds) != n:
        raise ValueError(f"got {len(seeds)} seeds for {n} members")
    for name, vals in (("learning_rates", learning_rates), ("weight_decays", weight_decays)):
        if vals is not None and len(vals) != n:
            raise ValueError(f"got {len(vals)} {name} for {n} members")
    models = []
    for i in range(n):
        seed = 0 if seeds is None else int(seeds[i])
        models.append(apply_initial_bias(create_model_config(config, device=device, seed=seed)))
    _refuse_dropout(models[0])
    model = _stacked_module(models)
    opt_cfg = config["NeuralNetwork"]["Training"]["Optimizer"]
    opt = _population_optimizer(opt_cfg, model, n, learning_rates, weight_decays)
    return PopulationState(model, opt, opt_cfg, n)


def population_template(config: dict, n_members: int, device="cuda") -> PopulationState:
    """A restore target with the ``[N]``-stacked structure: one member's
    initialisation N times (one model built, not N). The checkpoint's
    values (the per-member rates and decays too) replace it."""
    from ..models.create import create_model_config

    n = int(n_members)
    one = apply_initial_bias(create_model_config(config, device=device, seed=0))
    _refuse_dropout(one)
    model = _stacked_module([one] * n)
    opt_cfg = config["NeuralNetwork"]["Training"]["Optimizer"]
    return PopulationState(model, _population_optimizer(opt_cfg, model, n), opt_cfg, n)


def _member_rows(tensors: list[torch.Tensor], n: int) -> list[torch.Tensor]:
    return [t.detach().reshape(n, -1) for t in tensors]


def _snapshot(tensors: list[torch.Tensor], n: int) -> dict:
    """Per (dtype, device): the tensors and their ``[N, total]`` copy."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return {key: (ts, torch.cat(_member_rows(ts, n), dim=1)) for key, ts in groups.items()}


def _members_finite(loss: torch.Tensor, snap: dict, n: int) -> tuple[torch.Tensor, dict]:
    """``[N]`` bool (member ``i``'s loss and every tensor of its new state
    finite) and the new state's ``[N, total]`` rows per group."""
    ok = torch.isfinite(loss.reshape(n, -1)).all(dim=1)
    rows = {}
    for key, (ts, _) in snap.items():
        rows[key] = torch.cat(_member_rows(ts, n), dim=1)
        if ts[0].is_floating_point():
            ok = ok & torch.isfinite(rows[key]).all(dim=1)
    return ok, rows


def _revert(ok: torch.Tensor, snap: dict, rows: dict) -> None:
    """Members whose ``ok`` is False get their state from before the step
    back, in place; the others keep the bits they computed."""
    for key, (ts, before) in snap.items():
        kept = torch.where(ok[:, None], rows[key], before)
        parts = kept.split([t[0].numel() for t in ts], dim=1)
        torch._foreach_copy_(ts, [v.reshape(t.shape) for t, v in zip(ts, parts)])


def _task_weight_rows(task_weights, device) -> torch.Tensor:
    w = torch.as_tensor(np.asarray(task_weights, np.float32), device=device)
    if w.dim() != 2:
        raise ValueError(f"task_weights must be [n_members, n_tasks], got {tuple(w.shape)}")
    return w


def make_population_step(compute_dtype: torch.dtype = torch.float32,
                         loss_scale: float | None = None, task_weights=None) -> Callable:
    """``(PopulationState, batch) -> metrics``: one train step of every
    member on the shared ``batch``, each metric ``[N, ...]``.

    The forward and loss are ``torch.func.vmap`` over the members' slices
    of the stacked parameters and buffers (the batch norms update their
    stacked running statistics in place); one backward of the summed
    losses; zero gradients for parameters that got none, the frozen conv
    stack, the loss scale, as :func:`~.step.optimizer_step`; one optimizer
    step. Then the per-member revert (module docstring): a member whose
    loss or new state is not finite gets its state back, its metrics
    zeroed (``num_graphs`` 0: the epoch's weighted means skip it), and
    ``skipped`` = 1 in its entry.

    ``task_weights`` (``[N, n_tasks]``, normalized as ``ModelSpec``
    normalizes): per-member loss weights, a device tensor the step reads
    (made at its first, eager, call)."""
    loss_scale = None if not loss_scale or float(loss_scale) == 1.0 else float(loss_scale)
    weights: dict = {}

    def population_step(pstate: PopulationState, batch) -> dict:
        model, opt, n = pstate.model, pstate.optimizer, pstate.n
        params = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        w = None
        if task_weights is not None:
            w = weights.get(batch.device)
            if w is None:
                w = weights[batch.device] = _task_weight_rows(task_weights, batch.device)

        def member(p, b, wrow):
            pred = cast_forward(model, batch, compute_dtype, train=True, tensors=(p, b))
            tot, tasks = model.loss(pred, batch)
            if wrow is not None:
                tot = weighted_total(tasks, wrow)
            return tot, torch.stack(tasks)

        with torch.no_grad():
            snap = _snapshot(state_tensors(pstate), n)
        tot, tasks = torch.func.vmap(member, in_dims=(0, 0, None if w is None else 0))(
            params, buffers, w)
        opt.zero_grad()
        total = tot.sum()
        (total * loss_scale if loss_scale is not None else total).backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif loss_scale is not None:
                p.grad.div_(loss_scale)
        freeze_conv_grads(model)
        opt.step()
        pstate.step += 1
        with torch.no_grad():
            ok, rows = _members_finite(tot.detach(), snap, n)
            _revert(ok, snap, rows)
            graphs = batch.graph_mask.sum().expand(n)
            metrics = {
                "loss": torch.where(ok, tot.detach(), torch.zeros_like(tot)),
                "tasks_loss": torch.where(ok[:, None], tasks.detach(), torch.zeros_like(tasks)),
                "num_graphs": torch.where(ok, graphs, torch.zeros_like(graphs)),
                "skipped": (~ok).to(torch.int32),
            }
        return metrics

    return population_step


def make_population_eval_step(compute_dtype: torch.dtype = torch.float32) -> Callable:
    """``(PopulationState, batch) -> metrics``: the eval step of every
    member (eval-mode norms, no update), each metric ``[N, ...]``."""

    def population_eval_step(pstate: PopulationState, batch) -> dict:
        model = pstate.model

        def member(p, b):
            pred = cast_forward(model, batch, compute_dtype, train=False, tensors=(p, b))
            tot, tasks = model.loss(pred, batch)
            sses, counts = model.head_sse(pred, batch)
            return {"loss": tot, "tasks_loss": torch.stack(tasks),
                    "head_sse": torch.stack(sses), "head_count": torch.stack(counts),
                    "num_graphs": batch.graph_mask.sum()}

        with torch.no_grad():
            return torch.func.vmap(member)(dict(model.named_parameters()),
                                           dict(model.named_buffers()))

    return population_eval_step


def make_population_predict_step(pstate: PopulationState,
                                 compute_dtype: torch.dtype = torch.float32) -> Callable:
    """``batch -> per-head [N, rows, dim] fp32 predictions`` of every member
    (a ``var_output`` model's means), under ``torch.inference_mode``: the
    ensemble's predict step, one forward for all members."""
    model = pstate.model

    def member(p, b, batch):
        return head_means(model, cast_forward(model, batch, compute_dtype, train=False,
                                              tensors=(p, b)))

    def predict_step(batch):
        with torch.inference_mode():
            return torch.func.vmap(member, in_dims=(0, 0, None))(
                dict(model.named_parameters()), dict(model.named_buffers()), batch)

    return predict_step


def accumulate_members(step_metrics: list, extra_keys: tuple = (), *, n_members: int):
    """The member-resolved epoch reduction (the loop's ``accumulate`` with
    the ``[N]`` axis kept): ``(loss[N], tasks[N, T], extras{k: [N, ...]})``,
    weighted by each member's graph count, after one transfer per key. A
    member whose every step was skipped has weight 0 and reports NaN (a 0.0
    would win a best-member selection)."""
    n = int(n_members)
    if not step_metrics:
        return (np.full(n, np.nan), np.zeros((n, 0)), {k: None for k in extra_keys})
    host = {k: torch.stack([torch.as_tensor(m[k]) for m in step_metrics]).double().cpu().numpy()
            for k in ("num_graphs", "loss", "tasks_loss", *extra_keys)}
    g = host["num_graphs"].reshape(-1, n)  # [steps, N]
    loss = host["loss"].reshape(-1, n)
    with np.errstate(invalid="ignore"):
        tot = (loss * g).sum(axis=0)
    tasks = (host["tasks_loss"].reshape(g.shape[0], n, -1) * g[..., None]).sum(axis=0)
    extras = {k: host[k].reshape(g.shape[0], n, -1).sum(axis=0) for k in extra_keys}
    n_graphs = g.sum(axis=0)
    denom = np.maximum(n_graphs, 1.0)
    loss = np.where(n_graphs > 0, tot / denom, np.nan)
    tasks = np.where(n_graphs[:, None] > 0, tasks / denom[:, None], np.nan)
    return loss, tasks, extras


class _PendingRead:
    """A device tensor copied to the host behind the stream, read once its
    copy is done: the host waits for that step only, not for the steps
    queued after it."""

    def __init__(self, t: torch.Tensor):
        t = torch.as_tensor(t)
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def read(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class MemberTracker:
    """Per-member consecutive-skip streaks over the population's on-device
    ``skipped`` metrics: the population's counterpart of the resilience
    layer's ``SkipTracker``, which never raises. A diverged member must not
    take the other N - 1 down with a rollback: it is marked ``"diverged"``
    and left frozen (every step's select keeps reverting it). Each value is
    read only once ``lag`` later ones are queued, and only its own copy is
    waited for, so tracking adds no stall to the dispatch loop; the epoch
    loop drives it through its resilience hooks."""

    def __init__(self, n_members: int, max_consecutive: int, lag: int = 32):
        self.n_members = int(n_members)
        self.max_consecutive = int(max_consecutive)
        self.lag = max(0, int(lag))
        self.consecutive = np.zeros(self.n_members, np.int64)
        self.total = np.zeros(self.n_members, np.int64)
        self.diverged = np.zeros(self.n_members, bool)
        self.steps = 0
        self._pending: deque = deque()

    def push(self, skipped) -> None:
        self._pending.append(_PendingRead(skipped))
        while len(self._pending) > self.lag:
            self._drain_one()

    def finish(self) -> None:
        while self._pending:
            self._drain_one()

    def _drain_one(self) -> None:
        arr = np.asarray(self._pending.popleft().read(), np.int64).reshape(-1, self.n_members)
        for row in arr:
            self.steps += 1
            self.total += row
            self.consecutive = np.where(row > 0, self.consecutive + 1, 0)
            if self.max_consecutive > 0:
                self.diverged |= self.consecutive >= self.max_consecutive

    def statuses(self) -> list[str]:
        return ["diverged" if d else "ok" for d in self.diverged]

    def state_dict(self) -> dict:
        """The sidecar form (the deferred reads drained first: a snapshot
        mid-lag would under-count the streaks)."""
        self.finish()
        return {"diverged": [bool(d) for d in self.diverged],
                "consecutive": [int(c) for c in self.consecutive],
                "total": [int(t) for t in self.total], "steps": int(self.steps)}

    def load_state_dict(self, d: dict) -> None:
        """Restore a saved tracker: a member marked diverged stays diverged
        across a resume."""
        n = self.n_members
        self.diverged = np.asarray(d.get("diverged", [False] * n), bool).copy()
        self.consecutive = np.asarray(d.get("consecutive", [0] * n), np.int64).copy()
        self.total = np.asarray(d.get("total", [0] * n), np.int64).copy()
        self.steps = int(d.get("steps", 0))


class _PopulationEpochHooks:
    """What ``train_epoch`` asks of its resilience context, for a
    population: no chaos, watchdog or preemption, and the deferred
    per-member skip tracking (the full context's tracker raises and rolls
    the whole state back, which is wrong for one bad member)."""

    chaos = None
    dispatch_watchdog = None

    def __init__(self, tracker: MemberTracker):
        self._tracker = tracker
        self.current_epoch = 0
        self.skipped_total = 0
        self.interrupted = False
        self.epoch_raw_done = 0

    def stop_requested(self, *_args) -> bool:
        return False

    def watchdog_guard(self, _what):
        from contextlib import nullcontext

        return nullcontext()

    def new_tracker(self, lag: int) -> MemberTracker:
        self._tracker.lag = max(0, int(lag))
        return self._tracker


def _normalize_task_weights(weights, n_tasks: int) -> list[float]:
    """Per-member weights normalized as ``ModelSpec.from_config`` does (``w
    / sum|w|``), so a member whose weights are the spec's steps as a
    statically weighted run."""
    w = [float(x) for x in weights]
    if len(w) != n_tasks:
        raise ValueError(f"expected {n_tasks} task weights, got {len(w)}")
    wsum = sum(abs(x) for x in w)
    return [x / wsum for x in w]


def population_meta(n: int, epochs_done: int, tracker: MemberTracker | None = None) -> dict:
    """A population checkpoint's sidecar block: the member count (checked
    before a restore), the epochs the saved state has trained (the continue
    resume point) and the per-member divergence bookkeeping."""
    meta = {"population": int(n), "population_epochs_done": int(epochs_done)}
    if tracker is not None:
        meta["member_tracker"] = tracker.state_dict()
        meta["member_status"] = tracker.statuses()
    return meta


def fit_population(config: dict, train_loader, val_loader, *, n_members: int,
                   seeds: Sequence[int] | None = None,
                   learning_rates: Sequence[float] | None = None,
                   weight_decays: Sequence[float] | None = None,
                   task_weights: Sequence[Sequence[float]] | None = None, verbosity: int = 0,
                   walltime_check=None, initial_state: PopulationState | None = None,
                   start_epoch: int = 0, tracker_state: dict | None = None,
                   log_name: str | None = None, path: str = "./logs/", device="cuda",
                   capture: bool = True) -> tuple[PopulationState, dict]:
    """The population engine: N members of the augmented ``config``'s model
    trained as one step for ``Training.num_epoch`` epochs (at
    ``Training.steps_per_dispatch``/``HYDRAGNN_SUPERSTEP`` K > 1 in blocks
    of K batches). On the card each step is a replay of the population
    step's CUDA graph for its bucket (``capture=False``: eager).

    ``initial_state``, ``start_epoch`` and ``tracker_state``: the
    ``Training.continue`` resume point (a restored population, the first
    epoch not trained, the divergence bookkeeping). With ``log_name`` and
    ``Training.resilience.checkpoint_every_epoch`` every epoch writes a
    rolling population checkpoint whose sidecar carries the member
    statuses.

    Returns ``(pstate, summary)``: per-member records (status, final
    train/val loss, the member's hyperparameters) and the ensemble mean and
    variance of the surviving members' objectives."""
    from .. import telemetry as tel
    from ..capture import Dispatch
    from ..resilience import config_defaults
    from ..utils import flags, resolve_device
    from .loop import evaluate, train_epoch

    device = resolve_device(device)
    nn_cfg = config["NeuralNetwork"]
    training = nn_cfg["Training"]
    num_epoch = int(training["num_epoch"])
    precision = resolve_precision(str(training.get("precision", "fp32")), device)
    from .step import resolve_loss_scale

    n = int(n_members)
    if n < 1:
        raise ValueError(f"population training needs >= 1 member, got {n}")
    n_tasks = len(nn_cfg["Architecture"]["output_dim"])
    tw = None
    if task_weights is not None:
        if len(task_weights) != n:
            raise ValueError(f"got {len(task_weights)} task-weight rows for {n} members")
        tw = [_normalize_task_weights(row, n_tasks) for row in task_weights]
    pop_step = make_population_step(precision, resolve_loss_scale(training), task_weights=tw)
    k = resolve_steps_per_dispatch(training)
    eval_step = make_population_eval_step(precision)
    run_name = log_name or "population"
    if capture:
        dispatch_step = make_superstep(pop_step, k, ledger={
            "model": run_name, "kind": "population_step", "precision": str(precision)})
        eval_step = Dispatch(eval_step, "population eval", ledger={
            "model": run_name, "kind": "population_eval", "precision": str(precision)})
    else:
        from types import SimpleNamespace

        dispatch_step = SimpleNamespace(k=k, dispatch=pop_step)

    if initial_state is not None:
        if initial_state.n_members != n:
            raise ValueError(f"restored population has {initial_state.n_members} members but "
                             f"the config asks for {n}")
        pstate = initial_state
    else:
        pstate = create_population_state(config, n, seeds=seeds, learning_rates=learning_rates,
                                         weight_decays=weight_decays, device=device)

    res_cfg = training.get("resilience") or {}
    max_skips = int(res_cfg.get("max_consecutive_skips",
                                config_defaults()["max_consecutive_skips"]))
    tracker = MemberTracker(n, max_skips)
    if tracker_state:
        tracker.load_state_dict(tracker_state)
    hooks = _PopulationEpochHooks(tracker)
    acc = functools.partial(accumulate_members, n_members=n)
    if k > 1 and hasattr(train_loader, "set_superstep"):
        train_loader.set_superstep(k)
    skip_valtest = len(getattr(val_loader, "samples", ())) == 0
    checkpoint_every = bool(res_cfg.get("checkpoint_every_epoch")) and log_name

    train_loss = np.full(n, np.nan)
    val_loss = np.full(n, np.nan)
    history = []

    def finite_mean(xs):
        finite = [x for x in np.asarray(xs, np.float64) if np.isfinite(x)]
        return float(np.mean(finite)) if finite else None

    for epoch in range(start_epoch, num_epoch):
        train_loader.set_epoch(epoch)
        hooks.current_epoch = epoch
        tel.set_context(epoch=epoch)
        t_epoch0 = time.monotonic()
        train_loss, _ = train_epoch(dispatch_step, pstate, train_loader, resilience=hooks,
                                    accumulate=acc)
        if not skip_valtest:
            val_loss, _, _ = evaluate(eval_step, pstate, val_loader, accumulate=acc)
        if checkpoint_every:
            from .checkpoint import save_checkpoint

            save_checkpoint(pstate, log_name, epoch, path=path,
                            meta=population_meta(n, epoch + 1, tracker))
        history.append({"epoch": epoch, "train_loss": [float(x) for x in train_loss],
                        "val_loss": [float(x) for x in np.asarray(val_loss)]})
        tel.emit("epoch", epoch=epoch, members=n,
                 duration_s=round(time.monotonic() - t_epoch0, 4),
                 raw_batches=int(hooks.epoch_raw_done), train_loss=finite_mean(train_loss),
                 val_loss=None if skip_valtest else finite_mean(val_loss),
                 member_train_loss=history[-1]["train_loss"],
                 member_val_loss=None if skip_valtest else history[-1]["val_loss"])
        if verbosity > 0:
            fmt = "[" + ", ".join(f"{x:.6f}" for x in train_loss) + "]"
            vfmt = "" if skip_valtest else \
                ", val [" + ", ".join(f"{x:.6f}" for x in val_loss) + "]"
            print(f"Epoch: {epoch:04d}, population({n}) train {fmt}{vfmt}", flush=True)
        if walltime_check is not None and walltime_check():
            if verbosity > 0:
                print(f"Walltime guard tripped at epoch {epoch}", flush=True)
            break

    statuses = tracker.statuses()
    member_loss = np.asarray(train_loss if skip_valtest else val_loss, np.float64)
    # a diverged member's last loss is stale: it never looks finite downstream
    objectives = [float("inf") if st == "diverged" or not np.isfinite(v) else float(v)
                  for st, v in zip(statuses, member_loss)]
    finite = [v for v in objectives if np.isfinite(v)]
    summary = {
        "n_members": n,
        "steps_per_dispatch": k,
        "objective_split": "train" if skip_valtest else "val",
        "members": [
            {"member": i, "status": statuses[i], "objective": objectives[i],
             "train_loss": float(np.asarray(train_loss)[i]),
             "val_loss": float(np.asarray(val_loss)[i]),
             "skipped_steps": int(tracker.total[i]),
             "seed": None if seeds is None else int(seeds[i]),
             "learning_rate": None if learning_rates is None else float(learning_rates[i]),
             "weight_decay": None if weight_decays is None else float(weight_decays[i]),
             "task_weights": None if tw is None else tw[i]}
            for i in range(n)],
        "ensemble": {"mean": float(np.mean(finite)) if finite else None,
                     "variance": float(np.var(finite)) if finite else None,
                     "n_finite": len(finite)},
        "member_tracker": tracker.state_dict(),
        "start_epoch": int(start_epoch),
        "history": history,
    }
    return pstate, summary


def train_population(config: dict, train_loader, val_loader, test_loader, log_name: str,
                     verbosity: int = 0, walltime_check=None,
                     initial_state: PopulationState | None = None, start_epoch: int = 0,
                     tracker_state: dict | None = None, path: str = "./logs/", device="cuda",
                     seed: int = 0) -> tuple[PopulationState, dict]:
    """The config-driven front of :func:`fit_population`: reads
    ``Training.population`` (size, per-member seeds, learning rates, weight
    decays, task weights; the seeds default to ``seed .. seed + N - 1``, a
    deep ensemble's distinct initialisations), trains, evaluates the test
    split per member, and writes the summary as
    ``<path>/<log_name>/population.json``."""
    from ..capture import Dispatch
    from ..utils import resolve_device
    from .loop import evaluate

    device = resolve_device(device)
    training = config["NeuralNetwork"]["Training"]
    pop_cfg = training.get("population") or {}
    n = resolve_population_size(training)
    seeds = pop_cfg.get("seeds")
    if seeds is None:
        seeds = [int(seed) + i for i in range(n)]
    pstate, summary = fit_population(
        config, train_loader, val_loader, n_members=n, seeds=seeds,
        learning_rates=pop_cfg.get("learning_rates"),
        weight_decays=pop_cfg.get("weight_decays"), task_weights=pop_cfg.get("task_weights"),
        verbosity=verbosity, walltime_check=walltime_check, initial_state=initial_state,
        start_epoch=start_epoch, tracker_state=tracker_state, log_name=log_name, path=path,
        device=device)
    if len(getattr(test_loader, "samples", ())):
        precision = resolve_precision(str(training.get("precision", "fp32")), device)
        eval_step = Dispatch(make_population_eval_step(precision), "population eval")
        test_loss, _, test_rmse = evaluate(
            eval_step, pstate, test_loader, span="test",
            accumulate=functools.partial(accumulate_members, n_members=n))
        summary["test_loss"] = [float(x) for x in np.asarray(test_loss)]
        summary["test_rmse"] = np.asarray(test_rmse).tolist()
    summary_path = os.path.join(path, log_name, "population.json")
    os.makedirs(os.path.dirname(summary_path), exist_ok=True)
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=2)
    return pstate, summary


# dotted config paths run_hpo(backend="vmap") may vary INSIDE one population
# (tensors of the population state), mapped to fit_population's keywords;
# everything else changes the model and goes through per-trial evaluation
VMAP_SCALAR_KEYS = {
    "NeuralNetwork.Training.Optimizer.learning_rate": "learning_rates",
    "NeuralNetwork.Training.Optimizer.weight_decay": "weight_decays",
    "NeuralNetwork.Architecture.task_weights": "task_weights",
}


def make_population_objective(samples=None, rank: int = 0, world: int = 1,
                              device="cuda") -> Callable[[dict, list], list]:
    """The trial evaluator of ``run_hpo(backend="vmap")``: ``(base_config,
    member_assignments) -> [(objective, status)]``. ``member_assignments``
    are dicts keyed by :data:`VMAP_SCALAR_KEYS`; all members train as one
    population on the data of ``base_config`` (or ``samples``), each scored
    by its validation loss (the train loss without a validation split); a
    diverged member scores ``inf``."""

    def population_objective(base_config, member_assignments) -> list:
        from ..config import load_config, update_config
        from ..preprocess.load_data import dataset_loading_and_splitting
        from .optimizer import ensure_injected_weight_decay

        config = load_config(base_config)
        train_loader, val_loader, test_loader = dataset_loading_and_splitting(
            config, samples=samples, rank=rank, world=world)
        config = update_config(config, train_loader.samples, val_loader.samples,
                               test_loader.samples)
        n = len(member_assignments)
        unknown = {key for a in member_assignments for key in a} - set(VMAP_SCALAR_KEYS)
        if unknown:
            raise ValueError(f"non-vmappable keys in population assignments: {sorted(unknown)}")
        nn_cfg = config["NeuralNetwork"]
        opt_cfg = nn_cfg["Training"]["Optimizer"]
        if any("NeuralNetwork.Training.Optimizer.weight_decay" in a for a in member_assignments):
            ensure_injected_weight_decay(opt_cfg)
        defaults: dict[str, Any] = {
            "learning_rates": float(opt_cfg["learning_rate"]),
            "weight_decays": opt_cfg.get("weight_decay"),
            "task_weights": list(nn_cfg["Architecture"].get("task_weights")
                                 or [1.0] * len(nn_cfg["Architecture"]["output_dim"])),
        }
        kwargs: dict[str, Any] = {}
        for dotted, kw in VMAP_SCALAR_KEYS.items():
            if any(dotted in a for a in member_assignments):
                kwargs[kw] = [a.get(dotted, defaults[kw]) for a in member_assignments]
        _, summary = fit_population(config, train_loader, val_loader, n_members=n,
                                    verbosity=0, device=device, **kwargs)
        return [(m["objective"], m["status"]) for m in summary["members"]]

    return population_objective


__all__ = [
    "MemberTracker",
    "PopulationState",
    "VMAP_SCALAR_KEYS",
    "accumulate_members",
    "create_population_state",
    "fit_population",
    "make_population_eval_step",
    "make_population_objective",
    "make_population_predict_step",
    "make_population_step",
    "member_state",
    "population_meta",
    "population_template",
    "resolve_population_size",
    "stack_states",
    "train_population",
]
