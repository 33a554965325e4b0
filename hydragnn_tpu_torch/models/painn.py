"""PaiNN conv layer: the polarizable atom interaction network, with a scalar
channel ``s [N, F]`` and a vector channel ``v [N, 3, F]``.

Counterpart of ``hydragnn_tpu/models/painn.py``. Per layer:

* message: a filter ``W(sinc(d)) * cos_cutoff(d)`` (times
  ``edge_filter_1(silu(edge_filter_0(e)))`` with edge features) gates an MLP of the
  scalars at the edge's receiver, split into ``(gate_v, gate_edge,
  msg_s)``; ``v_msg = v[receiver] * gate_v + gate_edge * d_hat``; both are
  summed at the edge's *sender* (the reference's ``index_add_(0, edge[:,
  0])``) and added to ``s`` and ``v``;
* update: bias-free channel linears ``U v``, ``V v``; ``(a_vv, a_sv, a_ss) =
  MLP([||V v||, s])``; ``v += a_vv U v``, ``s += a_sv <U v, V v> + a_ss``
  (the last layer has no vector update);
* output embeddings: ``s`` through Linear-tanh-Linear to the output width,
  ``v`` through a bias-free channel Linear (not on the last layer).

The vector linears carry no bias (a bias on ``[N, 3, F]`` would add one
offset to every spatial component and break rotation equivariance). ``v``
starts at zero on the first layer, which receives the positions as
``equiv``. The stack has no feature norm.

On the card the sums are the segment-sum kernel over the senders' CSR
view, the ``[E, 3, F]`` vector messages flattened to ``[E, 3 F]``, summed
in fp32; the gathers of node rows onto the edges are ``gather_rows``,
whose backward is the segment-sum kernel over the receivers' view (the
position gathers' over both, for forces).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import ModelSpec
from ..graphs import segment
from ..graphs.graph import GraphBatch
from ..ops.fused_scatter import gather_rows
from .common import Dense
from .radial import cosine_cutoff, sinc_expansion


class PainnMessage(nn.Module):
    """Parameters ``filter_layer`` (``num_radial -> 3 ns``), with edge
    features ``edge_filter_0`` (``edge_dim -> ns``) and ``edge_filter_1``
    (``ns -> 3 ns``), ``scalar_mlp_0`` (``ns -> ns``) and ``scalar_mlp_1``
    (``ns -> 3 ns``)."""

    def __init__(self, node_size: int, num_radial: int, cutoff: float,
                 generator: torch.Generator | None = None, edge_dim: int = 0):
        super().__init__()
        self.node_size = node_size
        self.num_radial = num_radial
        self.cutoff = cutoff
        self.edge_dim = edge_dim
        self.filter_layer = Dense(num_radial, 3 * node_size, generator)
        if edge_dim:
            self.edge_filter_0 = Dense(edge_dim, node_size, generator)
            self.edge_filter_1 = Dense(node_size, 3 * node_size, generator)
        self.scalar_mlp_0 = Dense(node_size, node_size, generator)
        self.scalar_mlp_1 = Dense(node_size, 3 * node_size, generator)

    def forward(self, s, v, batch: GraphBatch, dist, unit_vec, recv_idx, send_idx):
        filter_w = self.filter_layer(sinc_expansion(dist, self.num_radial, self.cutoff))
        filter_w = filter_w * cosine_cutoff(dist, self.cutoff)[:, None]
        if self.edge_dim:
            filter_w = filter_w * self.edge_filter_1(F.silu(self.edge_filter_0(batch.edge_attr)))
        scalar_out = self.scalar_mlp_1(F.silu(self.scalar_mlp_0(s)))
        filter_out = filter_w * gather_rows(scalar_out, batch.receivers, recv_idx)
        gate_v, gate_edge, msg_s = torch.split(filter_out, self.node_size, dim=-1)
        v_msg = (gather_rows(v, batch.receivers, recv_idx) * gate_v[:, None, :]
                 + gate_edge[:, None, :] * unit_vec[:, :, None])
        em = batch.edge_mask
        n = batch.num_nodes
        ds = segment.segment_sum(msg_s * em[:, None], batch.senders, n, index=send_idx)
        dv = segment.segment_sum(v_msg * em[:, None, None], batch.senders, n, index=send_idx)
        return s + ds, v + dv


class PainnUpdate(nn.Module):
    """Parameters ``update_U``, ``update_V`` (``ns -> ns``, no bias),
    ``update_mlp_0`` (``2 ns -> ns``) and ``update_mlp_1`` (``ns -> 3 ns``,
    ``2 ns`` on the last layer)."""

    def __init__(self, node_size: int, last_layer: bool,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.node_size = node_size
        self.last_layer = last_layer
        self.update_U = Dense(node_size, node_size, generator, use_bias=False)
        self.update_V = Dense(node_size, node_size, generator, use_bias=False)
        self.update_mlp_0 = Dense(2 * node_size, node_size, generator)
        self.update_mlp_1 = Dense(node_size, (2 if last_layer else 3) * node_size, generator)

    def forward(self, s, v):
        uv = self.update_U(v)
        vv = self.update_V(v)
        vv_norm = torch.sqrt(torch.sum(vv * vv, dim=1) + 1e-16)
        h = self.update_mlp_1(F.silu(self.update_mlp_0(torch.cat([vv_norm, s], dim=-1))))
        inner = torch.sum(uv * vv, dim=1)
        if self.last_layer:
            a_sv, a_ss = torch.split(h, self.node_size, dim=-1)
            return s + a_sv * inner + a_ss, v
        a_vv, a_sv, a_ss = torch.split(h, self.node_size, dim=-1)
        return s + a_sv * inner + a_ss, v + a_vv[:, None, :] * uv


def output_embeddings(module: nn.Module, node_size: int, out_dim: int, last_layer: bool,
                      generator: torch.Generator | None = None) -> None:
    """``node_embed_0`` (``ns -> out``), ``node_embed_1`` (``out -> out``)
    and, unless ``last_layer``, ``vec_embed`` (``ns -> out``, no bias)."""
    module.node_embed_0 = Dense(node_size, out_dim, generator)
    module.node_embed_1 = Dense(out_dim, out_dim, generator)
    if not last_layer:
        module.vec_embed = Dense(node_size, out_dim, generator, use_bias=False)


def embed_outputs(module: nn.Module, s, v, last_layer: bool):
    s = module.node_embed_1(torch.tanh(module.node_embed_0(s)))
    return s, (v if last_layer else module.vec_embed(v))


class PaiNNConv(nn.Module):
    """One PaiNN layer: ``message``, ``update`` and the output embeddings
    (flax names)."""

    feature_norm = False  # the reference PAINNStack uses Identity feature layers

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.last_layer = layer >= spec.num_conv_layers - 1
        self.node_size = in_features
        self.message = PainnMessage(in_features, spec.num_radial or 6,
                                    float(spec.radius or 5.0), generator, spec.edge_dim)
        self.update = PainnUpdate(in_features, self.last_layer, generator)
        output_embeddings(self, in_features, out_dim or spec.hidden_dim, self.last_layer,
                          generator)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        # the first layer receives the positions: the vector channel starts 0
        v = (inv.new_zeros((batch.num_nodes, 3, self.node_size)) if equiv.dim() == 2
             else equiv)
        send_idx, recv_idx = batch.views(("senders",), ("receivers",))
        vec = batch.edge_vectors(recv_idx, send_idx)
        dist = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-18)
        s, v = self.message(inv, v, batch, dist, vec / dist[:, None], recv_idx, send_idx)
        s, v = self.update(s, v)
        return embed_outputs(self, s, v, self.last_layer)


__all__ = ["PaiNNConv", "PainnMessage", "PainnUpdate"]
