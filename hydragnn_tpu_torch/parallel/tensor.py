"""Tensor parallelism: column-parallel dense layers over a model group.

Counterpart of ``hydragnn_tpu/parallel/step.py``'s ``param_mode="tp"`` and
``mesh.py::tp_param_specs``. The JAX package shards every large weight's
feature axis over its ``model`` mesh axis and lets GSPMD propagate the
activation shardings and insert the collectives. The port runs one process
per GPU on a ``(data x model)`` grid of ranks (``mesh.py::TPGrid``) and
writes the collectives by hand, Megatron's way:

* a dense layer whose weight the column rule shards (``mesh.py::
  tp_shard_dim``: at least ``2**10`` entries, the output width divisible
  by the model width) computes this rank's block of output columns from
  its rows of the weight, its input entering through f (``comm.
  enter_replicated``: the identity forward, the all-reduce of the ranks'
  partial input gradients backward);
* its output stays this rank's shard of the features: the per-feature
  layers after it work on the shard (the activation, the masked batch
  norm with its slice of the statistics and parameters, GIN's ``eps`` and
  neighbour sum, the graph pooling), so the gather-scatter kernels (B1 and
  its backward) and the segment sums (B2) run on ``[E, C / n]`` and
  ``[N, C / n]``. The norm and GIN's conv learn of the shard here, not in
  the model code: inside the layout's forward they run as
  :class:`_ShardedNorm` and :class:`_ShardedGIN`, which call the model's
  own forward with their per-feature tensors sliced (``functional_call``);
* the next dense layer gathers the shard through g (``comm.
  gather_columns``: the all-gather of the ranks' column blocks forward,
  this rank's block of the replicated cotangent backward) before it
  computes, as does every layer that needs whole features;
* a replicated parameter read on a shard (a norm's scale and bias, ``eps``,
  a sharded layer's bias) enters the model group through f, so every rank
  holds its whole gradient; a sharded weight's gradient is its rows, whole
  on the rank that owns them.

The optimizer steps the weights' shards and the replicated parameters
(:class:`TPLayout`, as FSDP's layout); the gradients and the graph-count
weights are summed over the data group only; after the update the shards
and every norm's slice of running statistics are all-gathered over the
model group, so every rank holds the whole state between steps
(checkpoints and ``host_gather`` read it). The model group's ranks compute
the replicated parts alike and draw the same dropout masks.

The route holds every activation's width to its layer's: the stacks whose
layers between dense layers are per-feature take it (GIN; the JAX
package partitions any stack through GSPMD, the port refuses the others,
the conditioning modes, GPS, conv checkpointing and conv or per-node heads
loudly, ROADMAP item 9).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.nn.functional as F

from ..models.common import Dense, MaskedBatchNorm, intercept_dense
from ..models.gin import GINConv
from .comm import enter_replicated, gather_columns, live, sum_tensors
from .mesh import TP_MIN_SIZE, TPGrid, make_tp_grid, tp_shard_dim
from .step import Layout, Shard

TP_STACKS = ("GIN",)

# the model group of the forward running under TPLayout.forward_context,
# (group, rank, n), and the sharded module whose own forward is running
_SHARD: contextvars.ContextVar = contextvars.ContextVar("tp_shard", default=None)
_INSIDE: contextvars.ContextVar = contextvars.ContextVar("tp_inside", default=None)


def _entered(p: torch.Tensor, width: int, full: int) -> torch.Tensor:
    """A replicated per-feature parameter (last axis ``full`` wide; 0-d:
    one scalar for every feature) as a ``width``-wide shard of the features
    sees it: entered into the model group through f, whose backward sums
    the ranks' partial gradients, and cut to this rank's slice."""
    group, rank, n = _SHARD.get()
    if width * n != full:
        raise ValueError(f"a {width}-wide activation is no shard of {full} features over "
                         f"{n} ranks")
    p = enter_replicated(p, group)
    return p if p.dim() == 0 else p.narrow(-1, rank * width, width)


def _own_forward(module, swap: dict, *args):
    """``module``'s own forward with ``swap``'s tensors in place of its
    own."""
    token = _INSIDE.set(module)
    try:
        return torch.func.functional_call(module, swap, args)
    finally:
        _INSIDE.reset(token)


class _ShardedNorm(MaskedBatchNorm):
    """The masked batch norm on a feature shard: its slice of the scale and
    bias, and views of its slice of the running statistics (the EMA writes
    through them)."""

    def forward(self, x, mask, train=False):
        width, full = x.shape[-1], self.scale.shape[0]
        if width == full or _INSIDE.get() is self:
            return super().forward(x, mask, train)
        rank = _SHARD.get()[1]
        sl = slice(rank * width, (rank + 1) * width)
        return _own_forward(self, {"scale": _entered(self.scale, width, full),
                                   "bias": _entered(self.bias, width, full),
                                   "mean": self.mean[sl], "var": self.var[sl]}, x, mask, train)


class _ShardedGIN(GINConv):
    """GIN's conv on a feature shard: ``eps`` entered, so every rank holds
    its whole gradient."""

    def forward(self, inv, equiv, batch, train=False, generator=None):
        full = self.nn.dense_0.weight.shape[1]
        if inv.shape[-1] == full or _INSIDE.get() is self:
            return super().forward(inv, equiv, batch, train, generator)
        return _own_forward(self, {"eps": _entered(self.eps, inv.shape[-1], full)}, inv, equiv,
                            batch, train, generator)


_SHARDED = {MaskedBatchNorm: _ShardedNorm, GINConv: _ShardedGIN}


def default_tensor_parallel_size(world: int, arch: dict | None = None) -> int:
    """``Architecture.tensor_parallel_size``, else 4 when the world divides
    by 4, else 2 (``hydragnn_tpu/run_training.py:378-394``)."""
    size = (arch or {}).get("tensor_parallel_size")
    return int(size) if size else (4 if world % 4 == 0 else 2)


def validate_tensor_parallel_support(model, n_model: int) -> None:
    """Raise for what the route does not run (the module docstring)."""
    spec = model.spec
    if spec.mpnn_type not in TP_STACKS:
        raise NotImplementedError(
            f"tensor parallelism over {spec.mpnn_type}: the port runs it for {TP_STACKS} "
            "(its layers between dense layers are per-feature); the other stacks are a later "
            "slice (ROADMAP item 9)")
    if spec.global_attn_engine:
        raise NotImplementedError("tensor parallelism under GPS is not ported")
    if model.conditioning is not None:
        raise NotImplementedError("tensor parallelism with graph-attribute conditioning is not "
                                  "ported")
    if spec.conv_checkpointing:
        raise NotImplementedError("tensor parallelism with conv_checkpointing is not ported")
    if spec.enable_interatomic_potential:
        raise NotImplementedError("tensor parallelism of an interatomic potential is not ported")
    if any(b.node_type not in (None, "mlp") for b in spec.node_heads):
        raise NotImplementedError("tensor parallelism with conv or per-node heads is not ported")
    if spec.hidden_dim % n_model:
        raise ValueError(f"tensor_parallel_size={n_model} does not divide hidden_dim "
                         f"{spec.hidden_dim}")


@dataclasses.dataclass
class TPLayout(Layout):
    """The tensor-parallel layout: ``group`` is the model group (the shards
    gather over it), ``grid`` the rank grid, ``dense`` which dense layers
    are column-parallel (``id(module) -> (weight sharded, bias sharded)``)."""

    grid: TPGrid | None = None
    model: torch.nn.Module | None = None
    dense: dict = dataclasses.field(default_factory=dict)
    norms: list = dataclasses.field(default_factory=list)

    @property
    def data_group(self):
        return self.grid.data_group

    @property
    def n_data(self) -> int:
        return self.grid.n_data

    @property
    def data_index(self) -> int:
        return self.grid.data_index

    @contextlib.contextmanager
    def forward_context(self):
        """The forward's hooks: the dense layers run column-parallel, and
        the norms and GIN's convs take feature shards (their classes
        swapped for the sharded ones while it runs)."""
        swapped = [(m, type(m)) for m in self.model.modules() if type(m) in _SHARDED]
        token = _SHARD.set((self.group, self.rank, self.world))
        try:
            for m, cls in swapped:
                m.__class__ = _SHARDED[cls]
            with intercept_dense(self._dense):
                yield
        finally:
            for m, cls in swapped:
                m.__class__ = cls
            _SHARD.reset(token)

    def _dense(self, module, x: torch.Tensor):
        plan = self.dense.get(id(module))
        if plan is None:
            return None
        weight, bias = module.weight, module.bias
        n, r, in_f = self.world, self.rank, weight.shape[1]
        if x.shape[-1] != in_f:
            if x.shape[-1] * n != in_f:
                raise ValueError(f"a {x.shape[-1]}-wide input is no shard of {in_f} features")
            x = gather_columns(x, self.group)  # g
        dtype = torch.promote_types(x.dtype, weight.dtype)
        if bias is not None:
            dtype = torch.promote_types(dtype, bias.dtype)
        w_sharded, b_sharded = plan
        if not w_sharded:
            b = bias.to(dtype) if bias is not None else None
            return F.linear(x.to(dtype), weight.to(dtype), b)
        cols = weight.shape[0] // n
        w = weight.narrow(0, r * cols, cols)
        b = None
        if bias is not None:
            b = (bias if b_sharded else enter_replicated(bias, self.group)).narrow(0, r * cols,
                                                                                   cols)
            b = b.to(dtype)
        return F.linear(enter_replicated(x, self.group).to(dtype), w.to(dtype), b)  # f

    def reduce_grads(self, params) -> None:
        """A sharded weight's gradient is its rows (whole on this rank); the
        rest is whole on every rank of the model group. Everything is summed
        over the data group, in one all-reduce."""
        sharded = self.sharded_ids()
        for s in self.shards:
            s.shard.grad = s.param.grad.narrow(
                s.dim, self.rank * s.shard.shape[s.dim], s.shard.shape[s.dim]).contiguous()
        sum_tensors([p.grad for p in params if id(p) not in sharded]
                    + [s.shard.grad for s in self.shards], self.data_group)

    def gather_params(self) -> None:
        """The shards and each norm's slice of running statistics,
        all-gathered over the model group."""
        super().gather_params()
        if not live() or self.world == 1:
            return
        with torch.no_grad():
            for m in self.norms:
                w = m.mean.shape[0] // self.world
                for t in (m.mean, m.var):
                    t.copy_(self._gather(t[self.rank * w:(self.rank + 1) * w], 0))


def place_tensor_parallel(state, optimizer_config: dict, n_model: int, seed: int = 0,
                          min_size_to_shard: int = TP_MIN_SIZE):
    """Place ``state`` on a ``(world / n_model) x n_model`` grid: rank 0's
    parameters and buffers on every rank, the column rule's weights sharded
    over the model group and the optimizer rebuilt over the shards and the
    replicated parameters (a resumed state's moments cut into the shards), a
    fresh state's dropout generator seeded ``seed + data index`` on every
    data group but the first. Returns the state (its ``layout`` set)."""
    import torch.distributed as dist

    from ..train.optimizer import load_optimizer_state, select_optimizer

    model = state.model
    validate_tensor_parallel_support(model, n_model)
    grid = make_tp_grid(n_model)
    if live():
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, 0)
    if state.generator is not None and grid.data_index != 0 and int(state.step) == 0:
        state.generator = torch.Generator(device=state.generator.device).manual_seed(
            int(seed) + grid.data_index)
    layout = TPLayout(group=grid.model_group, mode="tp", grid=grid, model=model)
    world, rank = layout.world, layout.rank
    dense_params = {}
    for m in model.modules():
        if isinstance(m, Dense):
            dense_params[id(m.weight)] = m
            if m.bias is not None:
                dense_params[id(m.bias)] = m
        elif isinstance(m, MaskedBatchNorm) and m.mean.shape[0] % world == 0:
            layout.norms.append(m)
    opt_params = []
    for name, p in model.named_parameters():
        dim = tp_shard_dim(p.shape, n_model, min_size_to_shard)
        if dim is None:
            opt_params.append(p)
            continue
        if id(p) not in dense_params:
            raise NotImplementedError(f"tensor parallelism: {name} {tuple(p.shape)} falls under "
                                      "the column rule but is no dense layer's weight or bias")
        shard = torch.nn.Parameter(p.detach().chunk(world, dim=dim)[rank].clone())
        layout.shards.append(Shard(param=p, dim=dim, shard=shard))
        opt_params.append(shard)
    sharded = layout.sharded_ids()
    for m in model.modules():
        if isinstance(m, Dense):
            w_sh = id(m.weight) in sharded
            b_sh = m.bias is not None and id(m.bias) in sharded
            layout.dense[id(m)] = (w_sh, b_sh)
    full = state.optimizer.state_dict()
    state.optimizer = select_optimizer(optimizer_config, opt_params)
    load_optimizer_state(state.optimizer, layout.shard_optimizer_state(full, state.optimizer))
    state.layout = layout
    return state


__all__ = ["TPLayout", "TP_STACKS", "default_tensor_parallel_size", "place_tensor_parallel",
           "validate_tensor_parallel_support"]
