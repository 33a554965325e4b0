"""HydraModel — the multi-headed GNN skeleton.

Counterpart of ``hydragnn_tpu/models/base.py`` as far as the serving path
needs it: the conv stack with per-layer masked batch norm and activation,
mean/add/max/min graph pooling, and single-branch ``mlp`` graph and node
heads. Module names follow the flax ones (``graph_convs[i]`` is flax's
``graph_convs_{i}``, ``feature_layers[i]`` is ``feature_norm_{i}``,
``graph_shared[b]`` is ``graph_shared_{b}``, ``heads_NN[k][b]`` is
``head{k}_{b}``), so ``convert.load_jax_variables`` maps one onto the other.

Not in this slice (they raise ``NotImplementedError``): other conv stacks,
GPS, variance outputs, graph-attribute conditioning, ``mlp_per_node`` and
``conv`` node heads, multibranch heads, interatomic potentials, training.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..graphs import segment
from ..graphs.graph import GraphBatch
from .common import MLP, MaskedBatchNorm, get_activation
from .gin import GINConv

CONV_REGISTRY = {"GIN": GINConv}


def head_columns(spec: ModelSpec) -> list[tuple[str, int, int]]:
    """Per-head (kind, column_start, dim) into the columnar target arrays."""
    cols = []
    g_off = n_off = 0
    for dim, kind in zip(spec.output_dim, spec.output_type):
        if kind == "graph":
            cols.append(("graph", g_off, dim))
            g_off += dim
        else:
            cols.append(("node", n_off, dim))
            n_off += dim
    return cols


def _not_in_slice(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes with {where}")


def check_spec(spec: ModelSpec) -> None:
    """Raise ``NotImplementedError`` for what this slice of the port lacks."""
    if spec.mpnn_type not in CONV_REGISTRY:
        raise _not_in_slice(f"mpnn_type {spec.mpnn_type!r}", "a later slice (other conv stacks)")
    if spec.global_attn_engine:
        raise _not_in_slice("global attention (GPS)", "a later slice (GPS, kernel 4)")
    if spec.var_output:
        raise _not_in_slice("variance outputs (GaussianNLLLoss)", "the training slice")
    if spec.use_graph_attr_conditioning:
        raise _not_in_slice("graph-attribute conditioning", "a later slice")
    if spec.enable_interatomic_potential:
        raise _not_in_slice("interatomic potentials (MLIP)", "a later slice")
    if len(spec.graph_heads) > 1 or len(spec.node_heads) > 1:
        raise _not_in_slice("multibranch heads", "a later slice")
    for b in spec.node_heads:
        if (b.node_type or "mlp") != "mlp":
            raise _not_in_slice(f"node head type {b.node_type!r}", "a later slice")


class HydraModel(nn.Module):
    """Multi-headed GNN over padded graph batches. Parameters are
    initialised as flax initialises them, from ``generator``."""

    def __init__(self, spec: ModelSpec, generator: torch.Generator | None = None):
        super().__init__()
        check_spec(spec)
        self.spec = spec
        conv_cls = CONV_REGISTRY[spec.mpnn_type]
        self.graph_convs = nn.ModuleList([
            conv_cls(spec, i, spec.input_dim if i == 0 else spec.hidden_dim,
                     generator=generator)
            for i in range(spec.num_conv_layers)
        ])
        self.feature_layers = nn.ModuleList([
            MaskedBatchNorm(spec.hidden_dim) for _ in range(spec.num_conv_layers)
        ])
        hidden = spec.hidden_dim
        self.graph_shared = nn.ModuleDict()
        shared_out = {}
        for b in spec.graph_heads:
            if b.num_sharedlayers > 0 and b.dim_sharedlayers > 0:
                self.graph_shared[b.branch] = MLP(
                    hidden, (b.dim_sharedlayers,) * b.num_sharedlayers,
                    activation=spec.activation, act_last=True, generator=generator,
                )
                shared_out[b.branch] = b.dim_sharedlayers
            else:
                shared_out[b.branch] = hidden
        self._head_cols = head_columns(spec)
        self.heads_NN = nn.ModuleList()
        for kind, _, dim in self._head_cols:
            per_branch = nn.ModuleDict()
            for b in spec.graph_heads if kind == "graph" else spec.node_heads:
                feats = tuple(b.dim_headlayers[: b.num_headlayers]) + (dim,)
                in_f = shared_out[b.branch] if kind == "graph" else hidden
                per_branch[b.branch] = MLP(in_f, feats, activation=spec.activation,
                                           generator=generator)
            self.heads_NN.append(per_branch)

    # -- encoder ------------------------------------------------------------
    def embed(self, batch: GraphBatch):
        """Raw node features and positions (each stack's first conv lifts)."""
        return batch.x, batch.pos

    def conv_block(self, i: int, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch):
        """Conv layer ``i`` + feature norm + activation."""
        inv, equiv = self.graph_convs[i](inv, equiv, batch)
        inv = self.feature_layers[i](inv, batch.node_mask)
        return get_activation(self.spec.activation)(inv), equiv

    def encode(self, batch: GraphBatch):
        inv, equiv = self.embed(batch)
        for i in range(len(self.graph_convs)):
            inv, equiv = self.conv_block(i, inv, equiv, batch)
        return inv, equiv

    def pool(self, x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        data = x * batch.node_mask[:, None]
        use_kernel = data.is_cuda and self.spec.graph_pooling in ("add", "sum", "mean")
        return segment.global_pool(
            self.spec.graph_pooling, data, batch.batch, batch.num_graphs,
            index=batch.csr("batch") if use_kernel else None,
        )

    # -- full forward --------------------------------------------------------
    def forward(self, batch: GraphBatch, train: bool = False):
        if train:
            raise _not_in_slice("training forward", "the training slice")
        inv, equiv = self.encode(batch)
        return self.decode(inv, equiv, batch)

    def decode(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch):
        """Pooling + per-head decoders; returns one tensor per head."""
        x_graph = self.pool(inv, batch)
        outputs = []
        for ihead, (kind, _, dim) in enumerate(self._head_cols):
            (branch, head), = self.heads_NN[ihead].items()
            if kind == "graph":
                shared = self.graph_shared[branch] if branch in self.graph_shared else None
                o = head(shared(x_graph) if shared is not None else x_graph)
            else:
                o = head(inv)
            outputs.append(o[:, :dim])
        return outputs


__all__ = ["CONV_REGISTRY", "HydraModel", "check_spec", "head_columns"]
