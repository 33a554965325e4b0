"""EGNN conv layer (reference ``EGCLStack`` / ``E_GCL``): E(n)-equivariant
message passing.

Counterpart of ``hydragnn_tpu/models/egnn.py``. Per layer:

    m_ij = edge_mlp([h_i, h_j, ||d_ij||, e_ij])   (e_ij: the edge features, if any)
    x_i += mean_j(d_hat_ij * tanh(coord_mlp(m_ij)))   (equivariance on, not the last layer)
    h_i  = node_mlp([h_i, sum_j m_ij])

with ``d_ij = x_j - x_i + shift_ij`` over each edge ``i -> j`` (sender
``i``), lengths ``sqrt(|d|^2 + 1e-18)`` and ``d_hat = d / (length + 1)``.
Messages and coordinate updates are aggregated at the sender, as the
reference's ``unsorted_segment_sum(edge_feat, row)``. The stack has no
feature norm (``feature_norm = False``). Pad edges are masked out of both
aggregations; at a pad edge ``d = 0`` and the length is 1e-9, whose second
derivative is large but meets only masked (zero) upstream gradients.

Every gather of node rows onto edges goes through ``gather_rows``, whose
backward is the segment-sum kernel (no atomics), and the aggregations are
the segment-sum kernel over the senders' CSR view. Forces, and their
gradients in MLIP training, are then deterministic on the card, and MD
trajectories repeat bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..graphs.graph import GraphBatch
from .common import (MLP, coordinate_update_layers, edge_gather, edge_segment_sum,
                     equivariant_coordinate_update)


class EGNNConv(nn.Module):
    """Parameters ``edge_mlp`` (``2 * in + 1 + edge_dim -> hidden -> hidden``, both
    activated), ``coord_mlp_mlp_0``/``coord_mlp_mlp_out`` (equivariant
    layers only; the flax names of the JAX package's shared block) and
    ``node_mlp`` (``in + hidden -> hidden -> out``)."""

    feature_norm = False  # the reference EGCLStack uses Identity feature layers

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        hidden = spec.hidden_dim
        out = out_dim or hidden
        # the reference turns coordinate updates off on the last layer
        self.equivariant = bool(spec.equivariance) and layer < spec.num_conv_layers - 1
        self.edge_dim = spec.edge_dim
        self.edge_mlp = MLP(2 * in_features + 1 + self.edge_dim, (hidden, hidden),
                            activation=spec.activation,
                            act_last=True, generator=generator)
        if self.equivariant:
            coordinate_update_layers(self, hidden, "coord_mlp", generator)
        self.node_mlp = MLP(in_features + hidden, (hidden, out), activation=spec.activation,
                            generator=generator)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        n = batch.num_nodes
        s, r = batch.senders, batch.receivers
        on_card = inv.is_cuda
        # the CSR views serve the aggregations by sender and the gathers'
        # backward sums (built once per batch, on the card only)
        send_idx = batch.csr("senders") if on_card else None
        recv_idx = batch.csr("receivers") if on_card else None

        vec = edge_gather(equiv, r, recv_idx) - edge_gather(equiv, s, send_idx) + batch.edge_shifts
        lengths = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True) + 1e-18)
        coord_diff = vec / (lengths + 1.0)  # normalize=True, eps=1.0
        feats = [edge_gather(inv, s, send_idx), edge_gather(inv, r, recv_idx), lengths]
        if self.edge_dim:
            feats.append(batch.edge_attr)
        edge_in = torch.cat(feats, dim=-1)
        m = self.edge_mlp(edge_in)
        if self.equivariant:
            equiv = equiv + equivariant_coordinate_update(
                self, m, coord_diff, s, batch.edge_mask, n, tanh_bound=True,
                prefix="coord_mlp", send_index=send_idx)
        agg = edge_segment_sum(m * batch.edge_mask[:, None], s, n, index=send_idx)
        h = self.node_mlp(torch.cat([inv, agg], dim=-1))
        return h, equiv


__all__ = ["EGNNConv"]
