"""Data-parallel train and eval steps over ``torch.distributed``: DDP, FSDP
and, over a ``(data x model)`` grid, tensor parallelism (``tensor.py``).

Counterpart of ``hydragnn_tpu/parallel/step.py``. The JAX package runs one
SPMD program over a ``[D, ...]`` stack of batches; the port runs one
process per GPU, each rank on its own padded batch (slot ``r`` of each
group of D consecutive batches, ``GraphLoader.set_group``), with these
collectives, every one NCCL on the card and gloo on the CPU:

* **the loss is graph-count weighted over the ranks** (``:196-229``):
  ``sum_r loss_r ng_r / sum_r ng_r``, not DDP's equal mean of gradients.
  Each rank backpropagates its own loss, scales its gradients by ``ng_r /
  max(sum ng, 1)`` and the ranks' gradients are summed. A fill batch (an
  all-masked batch padding the epoch's last group) has ``ng = 0`` and
  weight 0. On one rank the weight is exactly 1 and every collective is
  the identity on the values, so the step is the one-device step, bit for
  bit;
* **the running statistics merge with binary weights** (``:155-174``): the
  mean over the ranks whose batch has real nodes, so a fill batch's norms
  (which keep their old statistics) dilute nothing;
* **SyncBatchNorm** (``Architecture.SyncBatchNorm``): the feature norms'
  count-weighted sums are summed over the ranks before the ratios
  (``MaskedBatchNorm.sync_group``), the exact union-batch statistics;
* ``freeze_conv_layers`` and ``loss_scale`` act as in the JAX step
  (``:236-247``): the scaled loss feeds the backward, the fp32 gradients
  are divided back, the metrics are unscaled.

**FSDP** (``HYDRAGNN_USE_FSDP``, ``HYDRAGNN_FSDP_STRATEGY`` other than
``NO_SHARD``) shards, by ``fsdp_param_specs``' rule
(:func:`~.mesh.fsdp_shard_dim`), each large parameter and its optimizer
state over the data ranks, by hand: the optimizer holds only this rank's
shard of such a parameter; its gradient is reduce-scattered (summed over
the ranks, this rank's shard kept); the optimizer steps the shards; the
updated shards are all-gathered into the full parameter before its next
use. Full parameters stay materialised between steps (the forward reads
them through ``functional_call``); what FSDP saves is the optimizer state
and its update. Its numbers are the replicated step's, to the order of the
reduce-scatter's sums. LAMB's trust ratio reads the whole parameter's norm
and is refused under FSDP. A checkpoint holds the one-device layout: the
shards' optimizer state is all-gathered before rank 0 writes it, and a
resumed run's state (loaded before the layout is placed) is cut into the
shards, so a continued FSDP run steps as an uninterrupted one.

**Tensor parallelism** (``param_mode="tp"``, ``tensor.py``) keeps the
layout's shape: its ``Layout`` is the model group's (shards gathered over
it), its gradients and graph counts are summed over its data group
(``Layout.data_group``), and its forward runs under the layout's hooks
(``Layout.forward_context``: column-parallel dense layers, feature-shard
norms).

A step given a tuple of batches (an elastic survivor's slots of a wider
saved group) takes them in one update (``parallel_optimizer_step_many``).

The steps keep the one-device contracts (``(state, batch) -> metrics``,
metrics on the device), so the epoch loop and, on the card, the CUDA
graphs of ``capture.py`` run them unchanged: NCCL collectives are captured
inside the train step's graph.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from ..models.common import MaskedBatchNorm
from ..train.step import TrainState, freeze_conv_grads
from .comm import all_reduce_sum, live, rank_of, sum_tensors, world_of
from .mesh import FSDP_MIN_SIZE, fsdp_shard_dim


@dataclasses.dataclass
class Shard:
    """A parameter sharded along ``dim``: the full ``param`` (the model's)
    and this rank's ``shard`` (the optimizer's)."""

    param: torch.nn.Parameter
    dim: int
    shard: torch.nn.Parameter


@dataclasses.dataclass
class Layout:
    """The parallel layout of a train state: its data ranks' process group
    (``None``: the default group) and, under FSDP, the sharded parameters."""

    group: object = None
    mode: str = "replicated"
    shards: list = dataclasses.field(default_factory=list)

    @property
    def world(self) -> int:
        return world_of(self.group)

    @property
    def rank(self) -> int:
        return rank_of(self.group)

    def sharded_ids(self) -> set:
        return {id(s.param) for s in self.shards}

    @property
    def data_group(self):
        """The group the gradients, graph counts and metrics are summed
        over (the tensor-parallel layout's data group)."""
        return self.group

    def forward_context(self):
        """Hooks the layout's forward runs under (none here)."""
        return contextlib.nullcontext()

    def agree_finite(self, ok: torch.Tensor) -> torch.Tensor:
        """The non-finite guard's verdict, the same on every rank: a layout
        whose ranks hold state of their own (shards, a pipeline stage's
        blocks) takes the minimum over the ranks, on the device; a
        replicated one's ranks decide alike already."""
        if self.mode == "replicated" or not live() or world_of() == 1:
            return ok
        flag = ok.to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return flag[0] > 0

    def _gather(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        """The full tensor of every rank's ``part`` along ``dim``, in rank
        order (all-gathered; a copy when no group is formed)."""
        part = part.movedim(dim, 0).contiguous()
        if not live():
            return part.clone().movedim(0, dim)
        out = part.new_empty((self.world * part.shape[0],) + tuple(part.shape[1:]))
        dist.all_gather_into_tensor(out, part, group=self.group)
        return out.movedim(0, dim)

    def gather_params(self) -> None:
        """All-gather every shard into its full parameter."""
        with torch.no_grad():
            for s in self.shards:
                s.param.data.copy_(self._gather(s.shard.data, s.dim))

    def reduce_grads(self, params) -> None:
        """Sum the gradients over the ranks: replicated parameters' in one
        all-reduce, each sharded parameter's reduce-scattered into its
        shard's gradient."""
        sharded = self.sharded_ids()
        sum_tensors([p.grad for p in params if id(p) not in sharded], self.group)
        for s in self.shards:
            g = s.param.grad.movedim(s.dim, 0).contiguous()
            if live():
                out = torch.empty_like(s.shard.data.movedim(s.dim, 0),
                                       memory_format=torch.contiguous_format)
                dist.reduce_scatter_tensor(out, g, group=self.group)
            else:
                out = g.clone()
            s.shard.grad = out.movedim(0, s.dim).contiguous()

    def _positions(self, optimizer) -> list:
        """``(index in the optimizer's state dict, shard)`` of every shard."""
        pos = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups
                                              for p in g["params"])}
        return [(pos[id(s.shard)], s) for s in self.shards]

    def full_optimizer_state(self, optimizer) -> dict:
        """The optimizer's state dict in the one-device layout: each shard's
        per-element state (moments, accumulators) all-gathered into its
        parameter's shape, the rest as it is. Every rank must call this."""
        sd = optimizer.state_dict()
        state = dict(sd["state"])
        for i, s in self._positions(optimizer):
            if i in state:
                state[i] = {k: (self._gather(v, s.dim) if _per_element(v, s.shard) else v)
                            for k, v in state[i].items()}
        return {**sd, "state": state}

    def place_loaded(self, optimizer, full: dict) -> None:
        """After a one-device layout's parameters were loaded into the full
        parameters: cut every shard from its parameter and load ``full``
        (a one-device optimizer state dict) into ``optimizer``'s shards."""
        from ..train.optimizer import load_optimizer_state

        with torch.no_grad():
            for s in self.shards:
                s.shard.data.copy_(s.param.detach().chunk(self.world, dim=s.dim)[self.rank])
        load_optimizer_state(optimizer, self.shard_optimizer_state(full, optimizer))

    def shard_optimizer_state(self, full: dict, optimizer) -> dict:
        """A one-device layout's optimizer state dict (``full``) cut to this
        rank's shards for ``optimizer``, which steps them."""
        state = dict(full["state"])
        for i, s in self._positions(optimizer):
            if i in state:
                state[i] = {k: (v.chunk(self.world, dim=s.dim)[self.rank].clone()
                                if _per_element(v, s.param) else v)
                            for k, v in state[i].items()}
        return {**full, "state": state}


def _per_element(v, p: torch.Tensor) -> bool:
    """Whether an optimizer state entry holds one value per entry of ``p``."""
    return torch.is_tensor(v) and v.dim() > 0 and v.shape == p.shape


def shard_state(state: TrainState, optimizer_config: dict, group=None,
                param_mode: str = "replicated", min_size_to_shard: int = FSDP_MIN_SIZE,
                seed: int = 0, n_model: int | None = None) -> TrainState:
    """Place a train state on the data ranks of ``group``: every rank's
    parameters and buffers made rank 0's, a fresh state's dropout generator
    seeded ``seed + rank`` on every rank but 0 (rank 0 keeps a one-device
    run's draws; a resumed state keeps what its checkpoint restored), with
    ``param_mode="tp"`` the tensor-parallel layout over ``n_model`` ranks
    per model group (``tensor.py``), and with ``param_mode="fsdp"`` the
    large parameters sharded and the optimizer rebuilt
    (``Training.Optimizer``) over the shards and the replicated parameters,
    its state (a resumed run's moments, step counts and learning rate) cut
    from the one-device optimizer's. Returns the state (its ``layout``
    set)."""
    if param_mode == "tp":
        from .tensor import default_tensor_parallel_size, place_tensor_parallel

        return place_tensor_parallel(state, optimizer_config,
                                     n_model or default_tensor_parallel_size(world_of()), seed)
    if param_mode not in ("replicated", "fsdp"):
        raise ValueError(f"unknown param_mode {param_mode!r}; expected 'replicated', 'fsdp' or "
                         "'tp'")
    model = state.model
    world, rank = world_of(group), rank_of(group)
    if live():
        src = 0 if group is None else dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, src, group=group)
    if state.generator is not None and rank != 0 and int(state.step) == 0:
        state.generator = torch.Generator(device=state.generator.device).manual_seed(
            int(seed) + rank)
    layout = Layout(group=group, mode=param_mode)
    if param_mode == "fsdp":
        if str(optimizer_config.get("type", "AdamW")).lower() in ("lamb", "fusedlamb"):
            raise NotImplementedError("LAMB under FSDP: its trust ratio needs the whole "
                                      "parameter's norm (not ported)")
        from ..train.optimizer import load_optimizer_state, select_optimizer

        opt_params = []
        for p in model.parameters():
            dim = fsdp_shard_dim(p.shape, world, min_size_to_shard)
            if dim is None:
                opt_params.append(p)
                continue
            shard = torch.nn.Parameter(p.detach().chunk(world, dim=dim)[rank].clone())
            layout.shards.append(Shard(param=p, dim=dim, shard=shard))
            opt_params.append(shard)
        full = state.optimizer.state_dict()
        state.optimizer = select_optimizer(optimizer_config, opt_params)
        load_optimizer_state(state.optimizer, layout.shard_optimizer_state(full, state.optimizer))
    state.layout = layout
    return state


def merge_replica_stats(model: torch.nn.Module, real: torch.Tensor, group=None) -> None:
    """Replace every feature norm's running statistics by their mean over
    the ranks whose batch had real nodes (``real``: this rank's 1.0 or
    0.0), in one all-reduce; a world of one keeps them bit for bit."""
    stats = [t for m in model.modules() if isinstance(m, MaskedBatchNorm)
             for t in (m.mean, m.var)]
    if not stats or not live():
        return
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) * real for t in stats] + [real.reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        total = torch.clamp(flat[-1], min=1.0)
        offset = 0
        for t in stats:
            n = t.numel()
            t.copy_((flat[offset:offset + n] / total).view_as(t))
            offset += n


def bind_sync_batch_norm(model: torch.nn.Module, group=None) -> None:
    """SyncBatchNorm over ``group`` when the model asks for it."""
    if model.spec.sync_batch_norm:
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                m.sync_group = group


def parallel_optimizer_step(state: TrainState, batch, tot: torch.Tensor, tasks,
                            loss_scale: float | None = None) -> dict:
    """``optimizer_step`` over the data ranks of ``state.layout``: the
    graph-count weights, the gradient sum (and under FSDP the
    reduce-scatter, the shards' update and their all-gather), the merged
    running statistics; the metrics are the ranks' weighted totals."""
    layout = state.layout
    group = layout.data_group if layout is not None else None
    model, optimizer = state.model, state.optimizer
    ng = batch.graph_mask.sum()
    ng_all = all_reduce_sum(ng.detach(), group)
    w = ng / torch.clamp(ng_all, min=1.0)
    optimizer.zero_grad()
    if layout is not None and layout.shards:
        model.zero_grad()  # the sharded parameters are not the optimizer's
    obj = tot * w
    (obj * loss_scale if loss_scale is not None else obj).backward()
    _update(state, loss_scale,
            lambda: merge_replica_stats(model, (batch.node_mask.sum() > 0).to(torch.float32),
                                        group))
    tasks = torch.stack([t.detach() for t in tasks])
    sums = all_reduce_sum(torch.cat([(tot.detach() * w).reshape(1), tasks * w]), group)
    return {"loss": sums[0], "tasks_loss": sums[1:], "num_graphs": ng_all}


def _update(state: TrainState, loss_scale, merge_stats) -> None:
    """After the backward: zero gradients for parameters that got none, the
    loss scale divided back out, the running statistics merged
    (``merge_stats()``), the frozen conv stack, the gradients summed over
    the ranks, one optimizer step, the shards gathered."""
    layout, model = state.layout, state.model
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif loss_scale is not None:
            p.grad.div_(loss_scale)
    merge_stats()
    freeze_conv_grads(model)
    if layout is not None:
        layout.reduce_grads(params)
    state.optimizer.step()
    if layout is not None:
        layout.gather_params()
    state.step += 1


def _forward_context(state: TrainState):
    layout = state.layout
    return layout.forward_context() if layout is not None else contextlib.nullcontext()


def parallel_optimizer_step_many(state: TrainState, batches, loss, loss_scale=None) -> dict:
    """One data-parallel update over several batches of this rank (an
    elastic survivor's slots of a wider saved group, its fill batches
    included): each batch's loss weighted by its graph count over every
    rank's batches, the gradients accumulated over them and summed over the
    ranks; each batch's running statistics moved from the same old ones,
    then merged with binary weights over every rank's batches, as if each
    batch had its own rank. The update is the wider group's, to the order
    of its sums."""
    layout = state.layout
    group = layout.data_group if layout is not None else None
    model, optimizer = state.model, state.optimizer
    ngs = [b.graph_mask.sum() for b in batches]
    ng_all = all_reduce_sum(torch.stack(ngs).sum().detach(), group)
    optimizer.zero_grad()
    if layout is not None and layout.shards:
        model.zero_grad()
    norms = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    old = [(m.mean.clone(), m.var.clone()) for m in norms]
    acc = [torch.zeros_like(t) for pair in old for t in pair]
    reals = torch.zeros((), device=ng_all.device)
    tots, tasks_w = [], []
    for b, ng in zip(batches, ngs):
        with torch.no_grad():
            for m, (mean, var) in zip(norms, old):
                m.mean.copy_(mean)
                m.var.copy_(var)
        with _forward_context(state):
            tot, tasks = loss(state, b)
        w = ng / torch.clamp(ng_all, min=1.0)
        obj = tot * w
        (obj * loss_scale if loss_scale is not None else obj).backward()
        real = (b.node_mask.sum() > 0).to(torch.float32)
        with torch.no_grad():
            stats = [t for m in norms for t in (m.mean, m.var)]
            for a, t in zip(acc, stats):
                a.add_(t * real)
        reals = reals + real
        tots.append(tot.detach() * w)
        tasks_w.append(torch.stack([t.detach() for t in tasks]) * w)
    def merge_stats():
        if not norms:
            return
        with torch.no_grad():
            flat = all_reduce_sum(torch.cat([a.reshape(-1) for a in acc] + [reals.reshape(1)]),
                                  group)
            total = torch.clamp(flat[-1], min=1.0)
            offset = 0
            for t in (t for m in norms for t in (m.mean, m.var)):
                t.copy_((flat[offset:offset + t.numel()] / total).view_as(t))
                offset += t.numel()

    _update(state, loss_scale, merge_stats)
    sums = all_reduce_sum(torch.cat([torch.stack(tots).sum().reshape(1),
                                     torch.stack(tasks_w).sum(0)]), group)
    return {"loss": sums[0], "tasks_loss": sums[1:], "num_graphs": ng_all}


def make_parallel_train_step(model: torch.nn.Module, compute_dtype: torch.dtype = torch.float32,
                             loss_scale: float | None = None):
    """``(state, batch) -> metrics``: one data-parallel step of this rank's
    batch, the plain or (interatomic potentials) the MLIP loss, over the
    ranks of ``state.layout``. A tuple of batches takes
    :func:`parallel_optimizer_step_many` (one update over all of them)."""
    loss_scale = None if not loss_scale or float(loss_scale) == 1.0 else float(loss_scale)
    if model.spec.enable_interatomic_potential:
        from ..models.mlip import make_mlip_train_loss

        loss = make_mlip_train_loss(model, compute_dtype)
    else:
        from ..train.step import make_train_loss

        loss = make_train_loss(compute_dtype)

    def train_step(state: TrainState, batch) -> dict:
        if isinstance(batch, tuple):
            return parallel_optimizer_step_many(state, batch, loss, loss_scale)
        with _forward_context(state):
            tot, tasks = loss(state, batch)
        return parallel_optimizer_step(state, batch, tot, tasks, loss_scale)

    return train_step


def make_parallel_eval_step(model: torch.nn.Module, compute_dtype: torch.dtype = torch.float32,
                            group=None):
    """``(state, batch) -> metrics`` over the data ranks: this rank's eval
    (or MLIP eval) step, its loss and task losses weighted by its graph
    count, and the squared errors, counts and graph counts summed over the
    ranks (every rank gets the totals)."""
    if model.spec.enable_interatomic_potential:
        from ..models.mlip import make_mlip_eval_step

        inner = make_mlip_eval_step(model, compute_dtype)
    else:
        from ..train.step import make_eval_step

        inner = make_eval_step(compute_dtype)

    def eval_step(state: TrainState, batch) -> dict:
        with _forward_context(state):
            m = inner(state, batch)
        grp = state.layout.data_group if state.layout is not None else group
        ng_all = all_reduce_sum(m["num_graphs"], grp)
        w = m["num_graphs"] / torch.clamp(ng_all, min=1.0)
        k, h = m["tasks_loss"].numel(), m["head_sse"].numel()
        sums = all_reduce_sum(torch.cat([(m["loss"] * w).reshape(1), m["tasks_loss"] * w,
                                         m["head_sse"], m["head_count"]]), grp)
        return {"loss": sums[0], "tasks_loss": sums[1:1 + k],
                "head_sse": sums[1 + k:1 + k + h], "head_count": sums[1 + k + h:],
                "num_graphs": ng_all}

    return eval_step


__all__ = ["Layout", "Shard", "bind_sync_batch_norm", "make_parallel_eval_step",
           "make_parallel_train_step", "merge_replica_stats", "parallel_optimizer_step",
           "shard_state"]
