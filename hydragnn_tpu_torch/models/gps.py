"""GPS global attention: every conv layer becomes local MPNN + per-graph
multi-head self-attention, each with residual and norm, summed and passed
through an MLP block.

Counterpart of ``hydragnn_tpu/models/gps.py`` for ``global_attn_type``
``multihead`` (the default):

* :class:`GraphMultiheadAttention` scatters the nodes into dense per-graph
  blocks ``[G, n_max, heads, Dh]`` (``n_max`` = ``max_graph_nodes``) and
  normalises the ``[G, heads, n_max, n_max]`` logits with the masked-softmax
  kernel, or, when a graph of the batch may exceed ``n_max``, runs the exact
  flat masked attention over all node pairs (plain ``torch.softmax``, as the
  JAX package leaves that path to XLA). The choice comes from collate's
  per-graph node bound (``BatchMeta.max_n_node``), on the host.
* :class:`GPSConv` wraps the architecture's local conv.

The query-key and attention-value products are plain ``einsum``s, as in the
JAX package. ``ring`` and ``performer`` attention are not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..graphs.graph import GraphBatch
from ..ops.fused_softmax import MASK_FILL, masked_softmax
from .common import Dense, Dropout, MaskedBatchNorm, get_activation


def positions_in_graph(batch: GraphBatch, n_max: int) -> torch.Tensor:
    """Each node's slot in its graph's dense block: real nodes of a graph
    are contiguous, so the slot is the node id minus the graph's first id
    (clipped to ``n_max - 1``; only pad nodes of the dummy graph clip)."""
    n_node = batch.n_node.long()
    starts = torch.cumsum(n_node, 0) - n_node
    slot = torch.arange(batch.num_nodes, device=n_node.device) - starts[batch.batch.long()]
    return torch.clamp(slot, 0, n_max - 1)


class GraphMultiheadAttention(nn.Module):
    """Self-attention among the nodes of each graph. ``n_max > 0`` enables
    the dense-block path."""

    def __init__(self, channels: int, heads: int, n_max: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        if channels % heads:
            raise ValueError(f"hidden_dim {channels} must divide by global_attn_heads {heads}")
        self.channels = channels
        self.heads = heads
        self.n_max = int(n_max or 0)
        for name in ("q", "k", "v", "out"):
            self.add_module(name, Dense(channels, channels, generator))

    def _flat_attention(self, q, k, v, batch: GraphBatch) -> torch.Tensor:
        logits = torch.einsum("nhd,mhd->hnm", q, k) / math.sqrt(q.shape[-1])
        same_graph = batch.batch[:, None] == batch.batch[None, :]
        valid = same_graph & (batch.node_mask[None, :] > 0)
        logits = torch.where(valid[None], logits, MASK_FILL)
        return torch.einsum("hnm,mhd->nhd", torch.softmax(logits, dim=-1), v)

    def _dense_attention(self, q, k, v, batch: GraphBatch) -> torch.Tensor:
        """Scatter to ``[G, n_max, heads, Dh]`` blocks, per-graph attention,
        gather back. Pad and clipped slots hold zeros and are masked."""
        g, n_max = batch.num_graphs, self.n_max
        slot = positions_in_graph(batch, n_max)
        gid = batch.batch.long()
        node_mask = batch.node_mask[:, None, None]

        def to_dense(x):
            buf = x.new_zeros((g, n_max) + tuple(x.shape[1:]))
            return buf.index_put((gid, slot), x * node_mask)

        qd, kd, vd = to_dense(q), to_dense(k), to_dense(v)
        valid = torch.arange(n_max, device=gid.device)[None, :] < batch.n_node[:, None]
        logits = torch.einsum("gnhd,gmhd->ghnm", qd, kd) / math.sqrt(q.shape[-1])
        attn = masked_softmax(logits, valid)
        out = torch.einsum("ghnm,gmhd->gnhd", attn, vd)
        return out[gid, slot] * node_mask

    def _dense_fits(self, batch: GraphBatch) -> bool:
        """Whether every graph of the batch fits a dense block: collate's
        certified bound when the batch has one, else the node counts."""
        bound = batch.meta.max_n_node if batch.meta is not None else None
        if bound is not None:
            return bound <= self.n_max
        return bool((batch.n_node <= self.n_max).all())

    def forward(self, h: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        n = h.shape[0]
        dh = self.channels // self.heads
        q = self.q(h).reshape(n, self.heads, dh)
        k = self.k(h).reshape(n, self.heads, dh)
        v = self.v(h).reshape(n, self.heads, dh)
        if self.n_max and self.n_max < n and self._dense_fits(batch):
            out = self._dense_attention(q, k, v, batch)
        else:
            out = self._flat_attention(q, k, v, batch)
        return self.out(out.reshape(n, self.channels))


class GPSConv(nn.Module):
    """One GPS layer around the architecture's local conv (flax names:
    ``local``, ``norm1..3``, ``attn``, ``mlp_0``, ``mlp_1`` and
    ``local_proj`` where the local conv's width differs)."""

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        from .base import CONV_REGISTRY

        local_cls = CONV_REGISTRY[spec.mpnn_type]
        self.local = local_cls(spec, layer, in_features, generator=generator)
        local_width = local_cls.out_features(spec, layer)
        self.residual_local = local_width == in_features
        self.norm1 = MaskedBatchNorm(local_width)
        self.attn = GraphMultiheadAttention(in_features, max(spec.global_attn_heads, 1),
                                            spec.max_graph_nodes or 0, generator)
        self.norm2 = MaskedBatchNorm(in_features)
        self.local_proj = (Dense(local_width, in_features, generator)
                           if local_width != in_features else None)
        self.mlp_0 = Dense(in_features, 2 * in_features, generator)
        self.mlp_1 = Dense(2 * in_features, in_features, generator)
        self.norm3 = MaskedBatchNorm(in_features)
        self.drop = Dropout(spec.dropout)
        self.activation = spec.activation

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        mask = batch.node_mask
        h_local, equiv = self.local(inv, equiv, batch, train, generator)
        h_local = self.drop(h_local, train, generator)
        if self.residual_local:
            h_local = h_local + inv
        h_local = self.norm1(h_local, mask, train)

        h_attn = self.drop(self.attn(inv, batch), train, generator)
        h_attn = self.norm2(h_attn + inv, mask, train)

        if self.local_proj is not None:
            h_local = self.local_proj(h_local)
        out = h_local + h_attn
        mlp = get_activation(self.activation)(self.mlp_0(out))
        mlp = self.drop(mlp, train, generator)
        mlp = self.drop(self.mlp_1(mlp), train, generator)
        return self.norm3(out + mlp, mask, train), equiv


__all__ = ["GPSConv", "GraphMultiheadAttention", "positions_in_graph"]
