"""Shared model components: activations, the masked losses, flax-style
dense layers, MLPs and dropout, and the padding-aware batch norm.

Counterpart of ``hydragnn_tpu/models/common.py``. Two behaviours of flax
are kept on purpose, because the port has to compute what the JAX package
computes:

* parameters are initialised as flax initialises them (truncated
  lecun-normal kernels, zero biases), from an explicit ``torch.Generator``;
* a dense layer promotes its input and parameters to their common type
  (``F.linear`` refuses mixed types, flax's ``Dense`` promotes), which is
  what makes the "bf16" predict path run fp32 after the first feature norm.

:func:`checkpointed` is the port of flax's ``nn.remat`` around a conv
layer (``Training.conv_checkpointing``): ``torch.utils.checkpoint`` with
the dropout masks of the first pass replayed in the recompute and the
running statistics moved once.

The edge-space helpers (``edge_gather``, ``edge_segment_sum`` and its
kin, ``edge_dropout``, ``edge_operand``, and ``Dense`` itself) are the one
boundary of the edge-sharded route (``parallel/large_graph.py``): every
stack reduces over edges through them, the one-device call bit for bit
outside :func:`edge_sharded`.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Iterator, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "selu": F.selu,
    "prelu": lambda x: torch.where(x >= 0, x, 0.25 * x),  # torch PReLU init slope
    "elu": F.elu,
    "lrelu_01": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "lrelu_025": lambda x: F.leaky_relu(x, negative_slope=0.25),
    "lrelu_05": lambda x: F.leaky_relu(x, negative_slope=0.5),
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
    "tanh": torch.tanh,
    "silu": F.silu,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'; supported: {sorted(_ACTIVATIONS)}"
        ) from None


# stddev of a unit normal truncated to [-2, 2]; flax divides by it so the
# truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None,
                  fan_in: int | None = None) -> torch.Tensor:
    """flax ``variance_scaling(1.0, "fan_in", "truncated_normal")`` on a
    ``[out, in]`` weight (fan_in = in unless given)."""
    fan_in = weight.shape[1] if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def variance_scaling_uniform_(weight: torch.Tensor, scale: float,
                              generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_avg", "uniform")`` on a ``[out,
    in]`` weight: uniform in +-sqrt(3 scale / ((in + out) / 2))."""
    fan_avg = (weight.shape[0] + weight.shape[1]) / 2.0
    limit = math.sqrt(3.0 * scale / fan_avg)
    with torch.no_grad():
        return weight.uniform_(-limit, limit, generator=generator)


# The one interception point of every Dense call (the counterpart of flax's
# ``nn.intercept_methods``, which the JAX package's quantized serving relies
# on): a function ``(module, x) -> y or None`` that ``Dense.forward`` asks
# first. A context variable, not a module attribute: the quantized serving
# certification runs the fp32 and int8 steps in turn on one thread, and
# several endpoints' dispatcher threads run steps at once, each in its own
# context.
_DENSE_INTERCEPTOR: contextvars.ContextVar = contextvars.ContextVar(
    "dense_interceptor", default=None)

# "no process group" for the losses and norms (``None`` is the default group)
_NO_GROUP = object()

# the edge-sharded route's process group while its forward runs
# (``parallel/large_graph.py``): each rank holds a shard of the edges and
# every node, so :func:`neighbour_sum` sums its shard and then the ranks'
# partial sums; unset, the batch's edges are all the edges
_EDGE_GROUP: contextvars.ContextVar = contextvars.ContextVar("edge_group", default=_NO_GROUP)
# with it, the leading sizes of this rank's edge-space tensors (its edges,
# GAT's extended layout, DimeNet's triplets), none of them a node or graph
# count: a parameter applied to a tensor of such rows is read on edge rows
# (:func:`edge_operand`)
_EDGE_ROWS: contextvars.ContextVar = contextvars.ContextVar("edge_rows", default=frozenset())

# the pass of a checkpointed region (:func:`checkpointed`) this thread is
# in: None outside one, ("record", masks) in its first pass, ("replay",
# iterator over those masks) in a recompute
_CHECKPOINT_PASS: contextvars.ContextVar = contextvars.ContextVar(
    "checkpoint_pass", default=None)


def _keep_mask(shape, keep_prob: float, generator: torch.Generator,
               device) -> torch.Tensor:
    """Dropout's keep mask: drawn from ``generator``, except in the
    recompute of a checkpointed region, which takes its first pass's masks
    in their order (the generator does not advance again)."""
    tape = _CHECKPOINT_PASS.get()
    if tape is not None and tape[0] == "replay":
        return next(tape[1])
    keep = torch.rand(shape, generator=generator, device=device) < keep_prob
    if tape is not None:
        tape[1].append(keep)
    return keep


def checkpointed(fn: Callable, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    instead of kept (``torch.utils.checkpoint``, non-reentrant, the whole
    function recomputed: no early stop, so a kernel inside launches exactly
    twice per backward). ``preserve_rng_state`` would restore only the
    default generators, and the port's dropout draws from an explicit one:
    here the recompute replays the first pass's dropout masks instead, and
    skips the running-statistics update of any batch norm inside, so the
    forward, the gradients and the state are bit-equal to ``fn`` without
    checkpointing. Under :func:`edge_sharded` the recompute runs in the
    first pass's edge group (and edge rows) too."""
    from torch.utils import checkpoint as ckpt

    masks: list = []
    passes = {"n": 0}
    # the recompute runs in the backward, after the edge-sharded step's
    # context has closed, and on the card on autograd's device thread,
    # which carries no context variable: it sets the first pass's edge
    # group itself, so its neighbour sums are the first pass's
    group, rows = _EDGE_GROUP.get(), _EDGE_ROWS.get()

    def run(*a):
        first = passes["n"] == 0
        passes["n"] += 1
        token = _CHECKPOINT_PASS.set(("record", masks) if first else ("replay", iter(masks)))
        edge_token, rows_token = _EDGE_GROUP.set(group), _EDGE_ROWS.set(rows)
        try:
            return fn(*a)
        finally:
            _EDGE_ROWS.reset(rows_token)
            _EDGE_GROUP.reset(edge_token)
            _CHECKPOINT_PASS.reset(token)

    with ckpt.set_checkpoint_early_stop(False):
        return ckpt.checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


@contextlib.contextmanager
def intercept_dense(fn: Callable[[nn.Module, torch.Tensor], torch.Tensor | None]
                    ) -> Iterator[None]:
    """Inside, every ``Dense`` call on this thread first calls ``fn(module,
    x)``: a tensor it returns is the layer's output, ``None`` lets the layer
    compute as usual. Outside, nothing changes."""
    token = _DENSE_INTERCEPTOR.set(fn)
    try:
        yield
    finally:
        _DENSE_INTERCEPTOR.reset(token)


class _PerMember(torch.autograd.Function):
    """``fn(*args)`` whose batching rule calls ``fn`` once per member: under
    ``torch.func.vmap`` over a population's members
    (``train/population.py``) a batched product rounds otherwise than the
    one product of a single model, in the forward and in autograd's
    backward; called per member, each product and its backward are the
    single model's, bit for bit. Outside ``vmap`` the backward recomputes
    ``fn`` (:func:`member_exact` calls this Function only under ``vmap``)."""

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.is_tensor = [torch.is_tensor(a) for a in inputs[1:]]
        ctx.others = [None if t else a for t, a in zip(ctx.is_tensor, inputs[1:])]
        ctx.save_for_backward(*[a for a in inputs[1:] if torch.is_tensor(a)])

    @staticmethod
    def backward(ctx, dout):
        saved = iter(ctx.saved_tensors)
        args = [next(saved).detach().requires_grad_(need) if t else a
                for t, a, need in zip(ctx.is_tensor, ctx.others, ctx.needs_input_grad[1:])]
        wanted = [a for a, need in zip(args, ctx.needs_input_grad[1:]) if need]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(ctx.fn(*args), wanted, dout, allow_unused=True))
        return (None, *[next(grads) if need else None for need in ctx.needs_input_grad[1:]])

    @staticmethod
    def vmap(info, in_dims, fn, *args):
        def member(a, dim, i):
            return a if dim is None else a.select(dim, i).contiguous()

        return torch.stack([fn(*[member(a, d, i) for a, d in zip(args, in_dims[1:])])
                            for i in range(info.batch_size)]), 0


def member_exact(fn: Callable, *args):
    """``fn(*args)``; under ``torch.func.vmap`` with a batched tensor among
    ``args``, one call of ``fn`` per member (:class:`_PerMember`), so each
    member computes what it computes alone. ``fn`` returns one tensor."""
    if any(torch.is_tensor(a) and torch._C._functorch.is_batchedtensor(a) for a in args):
        return _PerMember.apply(fn, *args)
    return fn(*args)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``y = x @ W.T + b`` after promoting ``x``, ``W``
    and ``b`` to their common dtype. ``weight`` is ``[out, in]``; with
    ``use_bias=False`` there is no ``bias`` parameter. Calls can be
    intercepted (:func:`intercept_dense`). Under ``torch.func.vmap`` (a
    population's members) the product is one ``F.linear`` per member
    (:func:`member_exact`). Applied to this rank's edge rows under
    :func:`edge_sharded`, its weight and bias enter the edge space
    (:func:`edge_operand`)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        interceptor = _DENSE_INTERCEPTOR.get()
        if interceptor is not None:
            y = interceptor(self, x)
            if y is not None:
                return y
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        if self.bias is not None:
            dtype = torch.promote_types(dtype, self.bias.dtype)
        bias = edge_operand(self.bias, x).to(dtype) if self.bias is not None else None
        return member_exact(F.linear, x.to(dtype), edge_operand(self.weight, x).to(dtype), bias)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, else set to
    0; outside train mode (or at rate 0) the input passes through. The keep
    mask is drawn from the explicit ``generator`` (on the input's device),
    which ``F.dropout`` cannot take; the train step passes the one it
    seeds from the run's seed."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("Dropout in train mode needs a torch.Generator (the train "
                             "step's), as flax needs a 'dropout' rng")
        keep_prob = 1.0 - self.rate
        keep = _keep_mask(x.shape, keep_prob, generator, x.device)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class MLP(nn.Module):
    """Dense stack with the activation between layers (the last layer is
    linear unless ``act_last``). Layers are named ``dense_{i}`` as in flax."""

    def __init__(self, in_features: int, features: Sequence[int], activation: str = "relu",
                 act_last: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.activation = activation
        self.act_last = act_last
        d = in_features
        for i, f in enumerate(self.features):
            self.add_module(f"dense_{i}", Dense(d, f, generator))
            d = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = get_activation(self.activation)
        n = len(self.features)
        for i in range(n):
            x = getattr(self, f"dense_{i}")(x)
            if i < n - 1 or self.act_last:
                x = act(x)
        return x


class MaskedBatchNorm(nn.Module):
    """Batch norm over valid rows only (padding excluded from the
    statistics), with the JAX package's semantics (``models/common.py``
    ``MaskedBatchNorm``), which ``nn.BatchNorm1d`` does not have:

    * train mode takes count-weighted two-pass statistics over the rows with
      ``mask = 1`` and normalises with the *biased* variance;
    * the running statistics move by flax's EMA, ``momentum = 0.9`` being
      the weight of the old value, and only when the batch has real rows;
    * a batch without real rows normalises with the running statistics;
    * eval mode normalises with the running statistics.

    ``scale``/``bias`` are parameters; the running ``mean``/``var`` are fp32
    buffers, updated in place, that stay fp32 when the parameters are cast
    to a compute dtype, as the JAX steps leave ``batch_stats`` uncast.

    ``sync_group`` (set by the parallel layouts, absent by default): the
    process group whose ranks' count-weighted sums are summed before the
    ratios, in train mode: SyncBatchNorm over the data ranks, and the halo
    route's partitioned node set. The sums are exact union statistics, and
    an all-masked rank (a fill batch) adds nothing to them."""

    sync_group = _NO_GROUP

    def __init__(self, features: int, epsilon: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features, dtype=torch.float32))
        self.register_buffer("var", torch.ones(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            # under vmap (a population) one member at a time: the batched
            # column sums of the statistics and of their backward would
            # add the rows in another order than the single model does
            return member_exact(self._train_norm, x, mask, self.scale, self.bias, self.mean,
                                self.var)
        y = (x - self.mean) * torch.rsqrt(self.var + self.epsilon)
        return y * self.scale + self.bias

    def _train_norm(self, x, mask, scale, bias, run_mean, run_var) -> torch.Tensor:
        """The train-mode normalisation with the given parameters and
        running statistics (``run_mean``/``run_var`` updated in place)."""
        m = mask.reshape(-1, 1).to(x.dtype)
        msum = m.sum()
        s1 = (x * m).sum(dim=0)
        if self.sync_group is not _NO_GROUP:
            from ..parallel.comm import all_reduce_sum

            msum, s1 = all_reduce_sum(msum, self.sync_group), all_reduce_sum(s1, self.sync_group)
        count = torch.clamp(msum, min=1.0)
        mean = s1 / count
        cv = (((x - mean) ** 2) * m).sum(dim=0)
        if self.sync_group is not _NO_GROUP:
            cv = all_reduce_sum(cv, self.sync_group)
        var = cv / count
        has_rows = msum > 0
        tape = _CHECKPOINT_PASS.get()
        # the EMA is gated on real rows: a zero-count batch keeps the
        # running statistics bit-identical; a checkpointed recompute
        # leaves them as its first pass moved them
        if tape is None or tape[0] == "record":
            with torch.no_grad():
                alpha = (1.0 - self.momentum) * has_rows.to(torch.float32)
                run_mean.copy_(run_mean + alpha * (mean.detach() - run_mean))
                run_var.copy_(run_var + alpha * (var.detach() - run_var))
        # like jnp.where, this promotes to the running statistics' fp32
        mean = torch.where(has_rows, mean, run_mean)
        var = torch.where(has_rows, var, run_var)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * scale + bias


@contextlib.contextmanager
def edge_sharded(group, batch=None) -> Iterator[None]:
    """Inside, the batch's edges (and DimeNet's triplets) are this rank's
    shard of ``group``'s: the edge-space helpers below add the collectives
    that make every node-level result whole on every rank (the
    edge-sharded route). ``batch``, this rank's share
    (``parallel/large_graph.py::edge_share``), names the edge rows on which
    parameters are read (:func:`edge_operand`); without it none are."""
    rows = frozenset()
    if batch is not None:
        from ..graphs.graph import edge_space_rows
        from ..parallel.comm import rank_of, world_of

        rows = edge_space_rows(batch.num_edges, batch.num_nodes, batch.idx_kj.shape[0],
                               world_of(group), rank_of(group))
        if rows & {batch.num_nodes, batch.num_graphs}:
            raise ValueError(
                f"edge_sharded: the share's edge rows {sorted(rows)} meet its node or graph "
                f"count ({batch.num_nodes}, {batch.num_graphs}), so a layer's rows do not "
                "tell edges from nodes; make the share with large_graph.edge_share")
    token, rows_token = _EDGE_GROUP.set(group), _EDGE_ROWS.set(rows)
    try:
        yield
    finally:
        _EDGE_ROWS.reset(rows_token)
        _EDGE_GROUP.reset(token)


# -- edge space ----------------------------------------------------------------
#
# The boundary between the replicated node space and the sharded edge space
# of the edge-sharded route, in one place. Each helper is the one-device call
# bit for bit when no edge group is set. Under :func:`edge_sharded`:
#
# * node -> edge: a node tensor enters through ``comm.enter_replicated``
#   at each gather, so its gradient sums the ranks' partial cotangents;
# * parameters used on edge rows enter the same way at each use: a
#   ``Dense`` applied to a tensor of this rank's edge rows, and the other
#   parameters read on edges (GAT's attention vector, the Bessel basis's
#   frequencies) through :func:`edge_operand`;
# * edge -> node sums, counts and means: the numerators and the counts are
#   summed over the ranks (``comm.exit_sum``) before any division;
# * edge -> node max and min: the local extreme keeps the reduction's
#   identity, the ranks' extremes are reduced, and only then do the
#   non-finite results become 0;
# * edge -> node softmax: B3's split form (``ops.fused_softmax``);
# * edge -> edge (DimeNet's triplets read edges of every rank): the rows
#   all-gathered (:func:`all_edge_rows`).


def edge_shard() -> tuple[int, int] | None:
    """``(world, rank)`` of the edge group inside :func:`edge_sharded`
    (``(1, 0)`` when no process group is formed), ``None`` outside it."""
    group = _EDGE_GROUP.get()
    if group is _NO_GROUP:
        return None
    from ..parallel.comm import rank_of, world_of

    return world_of(group), rank_of(group)


def enter_edges(x: torch.Tensor) -> torch.Tensor:
    """A replicated (node or parameter) tensor about to be read on this
    rank's edges: the identity, whose backward sums the ranks' cotangents
    under :func:`edge_sharded`."""
    group = _EDGE_GROUP.get()
    if group is _NO_GROUP:
        return x
    from ..parallel.comm import enter_replicated

    return enter_replicated(x, group)


def edge_operand(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A parameter ``p`` about to be applied to ``x``'s rows: entering the
    edge space (:func:`enter_edges`) where ``x`` is a tensor of this rank's
    edge rows under :func:`edge_sharded`, so its gradient sums the ranks'
    partial ones; ``p`` itself otherwise."""
    rows = _EDGE_ROWS.get()
    if rows and x.dim() and x.shape[0] in rows:
        return enter_edges(p)
    return p


def exit_edges(x: torch.Tensor) -> torch.Tensor:
    """This rank's partial sum over its edges, made whole: the sum over the
    ranks under :func:`edge_sharded` (backward: the identity)."""
    group = _EDGE_GROUP.get()
    if group is _NO_GROUP:
        return x
    from ..parallel.comm import exit_sum

    return exit_sum(x, group)


def all_edge_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows of every rank's edges, in rank order (``comm.gather_rows``,
    behind an :func:`enter_edges` because the rows are read on this rank's
    triplets: the gradient sums the ranks' cotangents, then keeps this
    rank's block), under :func:`edge_sharded` over several ranks; ``x``
    itself otherwise (one rank's rows are all the rows)."""
    shard = edge_shard()
    if shard is None or shard[0] == 1:
        return x
    from ..parallel.comm import gather_rows as gather_ranks

    return enter_edges(gather_ranks(x, _EDGE_GROUP.get()))


def edge_gather(x: torch.Tensor, ids: torch.Tensor, index=None) -> torch.Tensor:
    """``x[ids]`` onto this rank's edges through ``gather_rows`` (backward:
    the segment-sum kernel over ``index``), ``x`` entering the edge space
    (:func:`enter_edges`)."""
    from ..ops.fused_scatter import gather_rows

    return gather_rows(enter_edges(x), ids, index)


def edge_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                     index=None) -> torch.Tensor:
    """``segment.segment_sum`` of this rank's edge rows, summed over the
    ranks."""
    from ..graphs import segment

    return exit_edges(segment.segment_sum(data, segment_ids, num_segments, index))


def edge_segment_count(segment_ids: torch.Tensor, num_segments: int,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """``segment.segment_count`` of this rank's edges, summed over the
    ranks."""
    from ..graphs import segment

    return exit_edges(segment.segment_count(segment_ids, num_segments, weights))


def edge_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                      index=None) -> torch.Tensor:
    """``segment.segment_mean`` over every rank's edges: the sums and the
    counts summed over the ranks, then divided."""
    from ..graphs import segment

    return segment.segment_mean(data, segment_ids, num_segments, index=index,
                                combine=exit_edges)


def edge_segment_std(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                     index=None) -> torch.Tensor:
    """``segment.segment_std`` over every rank's edges, from the two means
    of :func:`edge_segment_mean`."""
    from ..graphs import segment

    return segment.segment_std(data, segment_ids, num_segments, index=index,
                               combine=exit_edges)


def edge_segment_extreme(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                         kind: str = "max") -> torch.Tensor:
    """``segment.segment_max`` (``kind="max"``) or ``segment_min`` over
    every rank's edges: the local extreme with the identity (+-inf) left in
    place, reduced over the ranks, then the non-finite results made 0. The
    cotangent of a segment's extreme is split among its tied entries over
    every rank, as one device splits it."""
    from ..graphs import segment

    group = _EDGE_GROUP.get()
    if group is _NO_GROUP:
        fn = segment.segment_max if kind == "max" else segment.segment_min
        return fn(data, segment_ids, num_segments)
    from ..parallel.comm import all_reduce_extreme

    local = segment.segment_extreme_raw(data, segment_ids, num_segments, kind)
    ties = torch.zeros_like(local).index_add_(
        0, segment_ids.long(), (data.detach() == local.detach()[segment_ids.long()]).to(
            local.dtype))
    return segment.zero_empty(all_reduce_extreme(local, group, kind, ties), kind)


def edge_segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                         index=None) -> torch.Tensor:
    """``segment.segment_softmax`` over every rank's entries: B3's split
    form under :func:`edge_sharded`, the fused form outside it."""
    from ..graphs import segment

    group = _EDGE_GROUP.get()
    if group is _NO_GROUP:
        return segment.segment_softmax(logits, segment_ids, num_segments, index)
    from ..ops.fused_softmax import split_segment_softmax

    flat = logits.reshape(logits.shape[0], -1)
    return split_segment_softmax(flat, segment_ids, num_segments, index,
                                 group).reshape(logits.shape)


def edge_dropout(drop: "Dropout", x: torch.Tensor, train: bool, generator,
                 total_rows: int | None, rows: torch.Tensor | None) -> torch.Tensor:
    """``drop(x)`` for ``x`` this rank's rows of an edge tensor of
    ``total_rows`` rows: every rank draws the mask over all the rows from
    the shared generator (so it advances as on one device) and keeps the
    rows ``rows`` of it (the global row of each of ``x``'s rows; -1 for a
    padding row, whose mask is 0). ``rows`` None: ``x`` is all the rows."""
    if rows is None or not train or drop.rate == 0.0 or drop.rate >= 1.0:
        return drop(x, train, generator)
    if generator is None:
        raise ValueError("Dropout in train mode needs a torch.Generator (the train "
                         "step's), as flax needs a 'dropout' rng")
    keep_prob = 1.0 - drop.rate
    keep = _keep_mask((total_rows,) + tuple(x.shape[1:]), keep_prob, generator, x.device)
    keep = torch.cat([keep, keep.new_zeros((1,) + tuple(x.shape[1:]))])[rows]
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def neighbour_sum(inv: torch.Tensor, batch) -> torch.Tensor:
    """``sum_j mask_ij h_j`` over each node's in-edges: the gather-scatter
    kernel with the edge mask as the per-edge weight, over the batch's
    cached CSR views, the receivers' for the forward and the senders' for
    the gradient with respect to ``inv`` (built only where that gradient is
    taken; conv layer 0's input needs none). Under :func:`edge_sharded`,
    this rank's edges, then the sum over the ranks."""
    from ..ops.fused_scatter import gather_scatter_sum

    inv = enter_edges(inv)
    on_card = inv.is_cuda
    agg = gather_scatter_sum(
        inv, batch.senders, batch.receivers, batch.num_nodes,
        weight=batch.edge_mask.to(inv.dtype),
        index=batch.csr("receivers") if on_card else None,
        send_index=(batch.csr("senders")
                    if on_card and inv.requires_grad and torch.is_grad_enabled() else None),
    )
    return exit_edges(agg)


def gather_ends(inv: torch.Tensor, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """``(inv[receivers], inv[senders])`` through ``gather_rows``, whose
    backward is the segment-sum kernel over the batch's cached receivers'
    and senders' CSR views (the senders' built only where that gradient is
    taken), not autograd's ``index_put_``; each through
    :func:`edge_gather`."""
    on_card = inv.is_cuda
    recv_idx = batch.csr("receivers") if on_card else None
    send_idx = (batch.csr("senders")
                if on_card and inv.requires_grad and torch.is_grad_enabled() else None)
    return (edge_gather(inv, batch.receivers, recv_idx),
            edge_gather(inv, batch.senders, send_idx))


def local_node_index(batch_ids: torch.Tensor, n_node: torch.Tensor,
                     num_nodes: int) -> torch.Tensor:
    """Each node's position within its own graph (collate packs a graph's
    nodes together), the index of ``mlp_per_node``'s weight banks."""
    offsets = torch.cumsum(n_node, 0) - n_node
    return torch.arange(num_nodes, dtype=batch_ids.dtype,
                        device=batch_ids.device) - offsets[batch_ids].to(batch_ids.dtype)


def coordinate_update_layers(module: nn.Module, hidden: int, prefix: str = "coord",
                             generator: torch.Generator | None = None) -> None:
    """Attach the gate MLP of :func:`equivariant_coordinate_update` to
    ``module`` as ``{prefix}_mlp_0`` (``hidden -> hidden``) and
    ``{prefix}_mlp_out`` (``hidden -> 1``, no bias, initialised with
    ``variance_scaling(1e-6, "fan_avg", "uniform")``, the reference's
    xavier_uniform with gain 0.001), the flax names of the JAX package."""
    module.add_module(f"{prefix}_mlp_0", Dense(hidden, hidden, generator))
    out = Dense(hidden, 1, generator, use_bias=False)
    variance_scaling_uniform_(out.weight, 1e-6, generator)
    module.add_module(f"{prefix}_mlp_out", out)


def equivariant_coordinate_update(module: nn.Module, edge_feat: torch.Tensor,
                                  coord_diff: torch.Tensor, senders: torch.Tensor,
                                  edge_mask: torch.Tensor, num_nodes: int, tanh_bound: bool,
                                  prefix: str = "coord", send_index=None) -> torch.Tensor:
    """The E(3) coordinate update of EGNN (reference ``E_GCL.coord_model``,
    JAX ``models/common.py::equivariant_coordinate_update``): a per-edge
    scalar gate ``{prefix}_mlp_out(relu({prefix}_mlp_0(edge_feat)))``,
    optionally tanh-bounded, times ``coord_diff``, clipped to +-100, masked,
    and averaged over each sender's edges (the sum through the segment-sum
    kernel over the senders' CSR view ``send_index``; under
    :func:`edge_sharded`, the sums and counts of every rank). Returns the
    per-node position delta ``[N, 3]``."""
    gate = F.relu(getattr(module, f"{prefix}_mlp_0")(edge_feat))
    gate = getattr(module, f"{prefix}_mlp_out")(gate)
    if tanh_bound:
        gate = torch.tanh(gate)
    trans = torch.clamp(coord_diff * gate, -100.0, 100.0) * edge_mask[:, None]
    agg = edge_segment_sum(trans, senders, num_nodes, index=send_index)
    cnt = edge_segment_count(senders, num_nodes, weights=edge_mask)
    return agg / torch.clamp(cnt, min=1.0)[:, None]


# -- masked losses -------------------------------------------------------------


def _masked_mean(terms: torch.Tensor, mask: torch.Tensor, per_row: int,
                 group=_NO_GROUP) -> torch.Tensor:
    """sum(terms) / max(real rows x row width, 1); with ``group`` (the halo
    route's data ranks, whose node rows are partitioned) both sums are
    summed over the ranks first, so every rank holds the union's mean."""
    s, n = terms.sum(), mask.sum() * per_row
    if group is not _NO_GROUP:
        from ..parallel.comm import all_reduce_sum

        s, n = all_reduce_sum(s, group), all_reduce_sum(n, group)
    return s / torch.clamp(n, min=1.0)


def _row_mask(mask: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (pred.dim() - 1))


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               group=_NO_GROUP) -> torch.Tensor:
    """Mean squared error over real (mask = 1) rows only."""
    m = _row_mask(mask, pred)
    return _masked_mean((pred - target) ** 2 * m, m, pred.shape[-1], group)


def masked_mae(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               group=_NO_GROUP) -> torch.Tensor:
    m = _row_mask(mask, pred)
    return _masked_mean(torch.abs(pred - target) * m, m, pred.shape[-1], group)


def masked_rmse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                group=_NO_GROUP) -> torch.Tensor:
    return torch.sqrt(masked_mse(pred, target, mask, group) + 1e-16)


def masked_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                     mask: torch.Tensor, group=_NO_GROUP) -> torch.Tensor:
    """torch SmoothL1Loss (beta = 1) over real rows: 0.5 d^2 for |d| < 1,
    else |d| - 0.5."""
    m = _row_mask(mask, pred)
    d = torch.abs(pred - target)
    huber = torch.where(d < 1.0, 0.5 * d**2, d - 0.5) * m
    return _masked_mean(huber, m, pred.shape[-1], group)


def masked_gaussian_nll(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                        var: torch.Tensor, group=_NO_GROUP) -> torch.Tensor:
    """``torch.nn.GaussianNLLLoss`` over real rows: ``0.5 (log var + (pred -
    target)^2 / var)``, the variance floored at 1e-6, the mean over real
    rows (the JAX package's ``masked_gaussian_nll``)."""
    # the floor filled on the variances' device: a captured step copies
    # nothing from the host
    var = torch.maximum(var, torch.full_like(var, 1e-6))
    m = _row_mask(mask, pred)
    nll = 0.5 * (torch.log(var) + (pred - target) ** 2 / var) * m
    return _masked_mean(nll, m, pred.shape[-1], group)


_LOSSES = {
    "mse": masked_mse,
    "mae": masked_mae,
    "rmse": masked_rmse,
    "smooth_l1": masked_smooth_l1,
}


def get_loss(name: str):
    """The masked loss ``(pred, target, mask) -> scalar``; GaussianNLLLoss
    takes the variances as a fourth argument. Each takes ``group=``: the
    process group whose ranks hold partitions of the rows (the halo
    route); absent, the loss is this process's alone."""
    if name == "GaussianNLLLoss":
        return masked_gaussian_nll
    try:
        return _LOSSES[name]
    except KeyError:
        raise ValueError(
            f"Unknown loss '{name}'; supported: {sorted(_LOSSES)} or GaussianNLLLoss"
        ) from None


__all__ = [
    "Dense",
    "Dropout",
    "checkpointed",
    "edge_sharded",
    "MLP",
    "MaskedBatchNorm",
    "coordinate_update_layers",
    "all_edge_rows",
    "edge_dropout",
    "edge_gather",
    "edge_operand",
    "edge_segment_count",
    "edge_segment_extreme",
    "edge_segment_mean",
    "edge_segment_softmax",
    "edge_segment_std",
    "edge_segment_sum",
    "edge_shard",
    "enter_edges",
    "equivariant_coordinate_update",
    "exit_edges",
    "gather_ends",
    "get_activation",
    "get_loss",
    "intercept_dense",
    "lecun_normal_",
    "local_node_index",
    "masked_gaussian_nll",
    "masked_mae",
    "masked_mse",
    "masked_rmse",
    "masked_smooth_l1",
    "neighbour_sum",
    "variance_scaling_uniform_",
]
