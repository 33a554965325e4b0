"""GPS global attention: every conv layer becomes local MPNN + per-graph
self-attention, each with residual and norm, summed and passed through an
MLP block.

Counterpart of ``hydragnn_tpu/models/gps.py``:

* :class:`GraphMultiheadAttention` (``global_attn_type`` ``multihead``, the
  default) scatters the nodes into dense per-graph blocks ``[G, n_max,
  heads, Dh]`` (``n_max`` = ``max_graph_nodes``) and normalises the ``[G,
  heads, n_max, n_max]`` logits with the masked-softmax kernel, or, when a
  graph of the batch may exceed ``n_max``, runs the exact flat masked
  attention over all node pairs (plain ``torch.softmax``, as the JAX
  package leaves that path to XLA). The choice comes from collate's
  per-graph node bound (``BatchMeta.max_n_node``), on the host.
* :class:`PerformerAttention` (``performer``): FAVOR+ linear attention on
  the flat node rows; its per-graph sums are two segment sums by graph
  (the segment-sum kernel over the ``batch`` CSR view), gathered back to
  the nodes with ``gather_rows`` (backward: the same kernel).
* :class:`GPSConv` wraps the architecture's local conv, any registered
  one. For the ``EDGE_MODELS`` convs the relative positional encodings
  ``rel_pe``, embedded to ``hidden_dim`` (``rel_pos_emb``) and fused with
  the edge features where there are any (``edge_emb``, ``edge_lin``), are
  the local conv's edge features, and the local conv is built for
  ``edge_dim = hidden_dim``. The JAX package decides this when it traces a
  batch with ``rel_pe``; GPS always attaches ``rel_pe``, so the port
  decides it at construction.

The query-key and attention-value products are plain ``einsum``s, as in the
JAX package. ``ring`` attention is not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..config.schema import EDGE_MODELS, ModelSpec
from ..graphs import segment
from ..graphs.graph import GraphBatch
from ..ops.fused_scatter import gather_rows
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


def _promoted_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over both operands cast to their common type, as
    ``jnp.einsum`` promotes."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dtype), b.to(dtype))


class PerformerAttention(nn.Module):
    """FAVOR+ softmax-kernel linear attention within each graph:

        out_i = phi(q_i) . sum_{j in g(i)} phi(k_j) v_j^T
                / phi(q_i) . sum_{j in g(i)} phi(k_j)

    with the positive random features ``phi(x) = exp(w . x' - |x'|^2 / 2 -
    stab) / sqrt(m)``, ``x' = x Dh^-1/4``. ``w [heads, Dh, m]`` is a fixed
    projection: a buffer drawn at construction from the model's generator
    and kept in the state dict and checkpoints (the JAX package draws it
    from a key hashed from the module path, which needs JAX; the tests load
    that draw through ``convert.load_jax_variables(..., projections=)``),
    cast to the features' dtype in the forward. The stabilisers, which
    cancel in the ratio, carry no gradient: the row's max for the queries,
    the graph's max (``segment_max``) for the keys. The denominator is
    clamped at 1e-9. ``m`` (``num_features``) defaults to ``Dh`` rounded up
    to a multiple of 8, at least 8."""

    def __init__(self, channels: int, heads: int, generator: torch.Generator | None = None,
                 num_features: int = 0):
        super().__init__()
        if channels % heads:
            raise ValueError(f"hidden_dim {channels} must divide by global_attn_heads {heads}")
        self.channels = channels
        self.heads = heads
        dh = channels // heads
        self.num_features = int(num_features) or max(8, (dh + 7) // 8 * 8)
        for name in ("q", "k", "v", "out"):
            self.add_module(name, Dense(channels, channels, generator))
        self.register_buffer("w", torch.randn((heads, dh, self.num_features),
                                              generator=generator))

    def forward(self, h: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        n, heads, m = h.shape[0], self.heads, self.num_features
        dh = self.channels // heads
        g = batch.num_graphs
        q = self.q(h).reshape(n, heads, dh)
        k = self.k(h).reshape(n, heads, dh)
        v = self.v(h).reshape(n, heads, dh)
        w = self.w.to(h.dtype)
        scale = float(dh) ** -0.25

        def phi(x, proj, stab):
            xs = x * scale
            norm = 0.5 * torch.sum(xs * xs, dim=-1, keepdim=True)
            return torch.exp(proj - norm - stab) / math.sqrt(float(m))

        kproj = _promoted_einsum("nhd,hdm->nhm", k * scale, w)
        per_graph = segment.segment_max(kproj.detach().amax(dim=-1), batch.batch, g)  # [G, H]
        k_stab = per_graph[batch.batch.long()][:, :, None]
        qproj = _promoted_einsum("nhd,hdm->nhm", q * scale, w)
        q_stab = qproj.detach().amax(dim=-1, keepdim=True)

        qp = phi(q, qproj, q_stab)  # [N, H, m]
        kp = phi(k, kproj, k_stab) * batch.node_mask[:, None, None]
        index = batch.csr("batch") if h.is_cuda else None
        kv = segment.segment_sum((kp[:, :, :, None] * v[:, :, None, :]).reshape(n, -1),
                                 batch.batch, g, index=index)  # [G, H m Dh]
        z = segment.segment_sum(kp.reshape(n, -1), batch.batch, g, index=index)  # [G, H m]
        num = _promoted_einsum("nhm,nhmd->nhd", qp,
                               gather_rows(kv, batch.batch, index).reshape(n, heads, m, dh))
        den = _promoted_einsum("nhm,nhm->nh", qp,
                               gather_rows(z, batch.batch, index).reshape(n, heads, m))
        out = num / torch.maximum(den, torch.full_like(den, 1e-9))[..., None]
        out = out * batch.node_mask[:, None, None]
        return self.out(out.reshape(n, self.channels))


class GPSConv(nn.Module):
    """One GPS layer around the architecture's local conv (flax names:
    ``local``, ``norm1..3``, ``attn``, ``mlp_0``, ``mlp_1``, ``local_proj``
    where the local conv's width differs, and, around an ``EDGE_MODELS``
    conv, ``rel_pos_emb`` (``pe_dim -> hidden``, no bias) with ``edge_emb``
    (``edge_dim -> hidden``) and ``edge_lin`` (``2 hidden -> hidden``), both
    without bias, where the model has edge features)."""

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        from .base import CONV_REGISTRY

        local_cls = CONV_REGISTRY[spec.mpnn_type]
        self.rel_pos_emb = self.edge_emb = self.edge_lin = None
        local_spec = spec
        if spec.mpnn_type in EDGE_MODELS:
            c = spec.hidden_dim
            self.rel_pos_emb = Dense(spec.pe_dim or 1, c, generator, use_bias=False)
            if spec.edge_dim:
                self.edge_emb = Dense(spec.edge_dim, c, generator, use_bias=False)
                self.edge_lin = Dense(2 * c, c, generator, use_bias=False)
            local_spec = dataclasses.replace(spec, edge_dim=c)
        self.local = local_cls(local_spec, layer, in_features, generator=generator)
        local_width = local_cls.out_features(spec, layer)
        self.residual_local = local_width == in_features
        self.norm1 = MaskedBatchNorm(local_width)
        heads = max(spec.global_attn_heads, 1)
        if (spec.global_attn_type or "multihead") == "performer":
            self.attn = PerformerAttention(in_features, heads, generator)
        else:
            self.attn = GraphMultiheadAttention(in_features, heads, spec.max_graph_nodes or 0,
                                                generator)
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
        local_batch = batch
        if self.rel_pos_emb is not None:
            # the local conv's edge features: the embedded relative
            # encodings, fused with the embedded edge features
            e = self.rel_pos_emb(batch.rel_pe)
            if self.edge_emb is not None:
                e = self.edge_lin(torch.cat([self.edge_emb(batch.edge_attr), e], dim=-1))
            local_batch = batch.with_edge_attr(e)
        h_local, equiv = self.local(inv, equiv, local_batch, train, generator)
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


__all__ = ["GPSConv", "GraphMultiheadAttention", "PerformerAttention", "positions_in_graph"]
