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
    checkpointing."""
    from torch.utils import checkpoint as ckpt

    masks: list = []
    passes = {"n": 0}

    def run(*a):
        first = passes["n"] == 0
        passes["n"] += 1
        token = _CHECKPOINT_PASS.set(("record", masks) if first else ("replay", iter(masks)))
        try:
            return fn(*a)
        finally:
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


class Dense(nn.Module):
    """flax ``nn.Dense``: ``y = x @ W.T + b`` after promoting ``x``, ``W``
    and ``b`` to their common dtype. ``weight`` is ``[out, in]``; with
    ``use_bias=False`` there is no ``bias`` parameter. Calls can be
    intercepted (:func:`intercept_dense`)."""

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
        bias = self.bias.to(dtype) if self.bias is not None else None
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


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
    to a compute dtype, as the JAX steps leave ``batch_stats`` uncast."""

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
            m = mask.reshape(-1, 1).to(x.dtype)
            msum = m.sum()
            count = torch.clamp(msum, min=1.0)
            mean = (x * m).sum(dim=0) / count
            var = (((x - mean) ** 2) * m).sum(dim=0) / count
            has_rows = msum > 0
            tape = _CHECKPOINT_PASS.get()
            # the EMA is gated on real rows: a zero-count batch keeps the
            # running statistics bit-identical; a checkpointed recompute
            # leaves them as its first pass moved them
            if tape is None or tape[0] == "record":
                with torch.no_grad():
                    alpha = (1.0 - self.momentum) * has_rows.to(torch.float32)
                    self.mean.copy_(self.mean + alpha * (mean.detach() - self.mean))
                    self.var.copy_(self.var + alpha * (var.detach() - self.var))
            # like jnp.where, this promotes to the running statistics' fp32
            mean = torch.where(has_rows, mean, self.mean)
            var = torch.where(has_rows, var, self.var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias


def neighbour_sum(inv: torch.Tensor, batch) -> torch.Tensor:
    """``sum_j mask_ij h_j`` over each node's in-edges: the gather-scatter
    kernel with the edge mask as the per-edge weight, over the batch's
    cached CSR views, the receivers' for the forward and the senders' for
    the gradient with respect to ``inv`` (built only where that gradient is
    taken; conv layer 0's input needs none)."""
    from ..ops.fused_scatter import gather_scatter_sum

    on_card = inv.is_cuda
    return gather_scatter_sum(
        inv, batch.senders, batch.receivers, batch.num_nodes,
        weight=batch.edge_mask.to(inv.dtype),
        index=batch.csr("receivers") if on_card else None,
        send_index=(batch.csr("senders")
                    if on_card and inv.requires_grad and torch.is_grad_enabled() else None),
    )


def gather_ends(inv: torch.Tensor, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """``(inv[receivers], inv[senders])`` through ``gather_rows``, whose
    backward is the segment-sum kernel over the batch's cached receivers'
    and senders' CSR views (the senders' built only where that gradient is
    taken), not autograd's ``index_put_``."""
    from ..ops.fused_scatter import gather_rows

    on_card = inv.is_cuda
    recv_idx = batch.csr("receivers") if on_card else None
    send_idx = (batch.csr("senders")
                if on_card and inv.requires_grad and torch.is_grad_enabled() else None)
    return (gather_rows(inv, batch.receivers, recv_idx),
            gather_rows(inv, batch.senders, send_idx))


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
    kernel over the senders' CSR view ``send_index``). Returns the per-node
    position delta ``[N, 3]``."""
    from ..graphs import segment

    gate = F.relu(getattr(module, f"{prefix}_mlp_0")(edge_feat))
    gate = getattr(module, f"{prefix}_mlp_out")(gate)
    if tanh_bound:
        gate = torch.tanh(gate)
    trans = torch.clamp(coord_diff * gate, -100.0, 100.0) * edge_mask[:, None]
    agg = segment.segment_sum(trans, senders, num_nodes, index=send_index)
    cnt = segment.segment_count(senders, num_nodes, weights=edge_mask)
    return agg / torch.clamp(cnt, min=1.0)[:, None]


# -- masked losses -------------------------------------------------------------


def _masked_mean(terms: torch.Tensor, mask: torch.Tensor, per_row: int) -> torch.Tensor:
    """sum(terms) / max(real rows x row width, 1)."""
    return terms.sum() / torch.clamp(mask.sum() * per_row, min=1.0)


def _row_mask(mask: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (pred.dim() - 1))


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over real (mask = 1) rows only."""
    m = _row_mask(mask, pred)
    return _masked_mean((pred - target) ** 2 * m, m, pred.shape[-1])


def masked_mae(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = _row_mask(mask, pred)
    return _masked_mean(torch.abs(pred - target) * m, m, pred.shape[-1])


def masked_rmse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(masked_mse(pred, target, mask) + 1e-16)


def masked_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """torch SmoothL1Loss (beta = 1) over real rows: 0.5 d^2 for |d| < 1,
    else |d| - 0.5."""
    m = _row_mask(mask, pred)
    d = torch.abs(pred - target)
    huber = torch.where(d < 1.0, 0.5 * d**2, d - 0.5) * m
    return _masked_mean(huber, m, pred.shape[-1])


def masked_gaussian_nll(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                        var: torch.Tensor) -> torch.Tensor:
    """``torch.nn.GaussianNLLLoss`` over real rows: ``0.5 (log var + (pred -
    target)^2 / var)``, the variance floored at 1e-6, the mean over real
    rows (the JAX package's ``masked_gaussian_nll``)."""
    # the floor filled on the variances' device: a captured step copies
    # nothing from the host
    var = torch.maximum(var, torch.full_like(var, 1e-6))
    m = _row_mask(mask, pred)
    nll = 0.5 * (torch.log(var) + (pred - target) ** 2 / var) * m
    return _masked_mean(nll, m, pred.shape[-1])


_LOSSES = {
    "mse": masked_mse,
    "mae": masked_mae,
    "rmse": masked_rmse,
    "smooth_l1": masked_smooth_l1,
}


def get_loss(name: str):
    """The masked loss ``(pred, target, mask) -> scalar``; GaussianNLLLoss
    takes the variances as a fourth argument."""
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
    "MLP",
    "MaskedBatchNorm",
    "coordinate_update_layers",
    "equivariant_coordinate_update",
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
