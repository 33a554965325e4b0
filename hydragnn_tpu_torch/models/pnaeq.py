"""PNAEq conv layer: PaiNN's scalar and vector channels, with the scalar
messages aggregated by PNA's degree-scaled multi-aggregator instead of a
plain sum.

Counterpart of ``hydragnn_tpu/models/pnaeq.py``. Per layer: the edge
lengths' Bessel basis (with its envelope; trainable ``rbf.freq``),
embedded by ``tanh(rbf_emb(.))``; ``pre_nn`` of ``[s[sender],
s[receiver], rbf embedding]``; a scalar MLP (tanh, silu) gated by
``rbf_lin(rbf)`` and split into ``(gate_v, gate_edge, msg_s)``; ``msg_s``
aggregated at the sender by mean, min, max and std under five degree
scalers (PNA's four and inverse_linear) and mixed by ``post_nn`` with
``s``; the vector message ``v[receiver] gate_v + gate_edge d_hat``
summed at the sender; residuals; then PaiNN's update and output
embeddings. No feature norm.

On the card the mean and the std's two means are three launches of the
segment-sum kernel over the senders' CSR view and the vector sum a fourth,
its ``[E, 3, F]`` messages flattened to ``[E, 3 F]``; min and max stay
plain ``scatter_reduce``, as in PNA. Gathers are ``gather_rows``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import ModelSpec
from ..graphs.graph import GraphBatch
from .common import Dense, edge_gather, edge_segment_sum
from .painn import PainnUpdate, embed_outputs, output_embeddings
from .pna import (AGGREGATORS, PNAEQ_SCALERS, avg_degree_linear, degree_scaled_aggregate,
                  log_degree_mean)
from .radial import BesselBasis


class PNAEqConv(nn.Module):
    """Parameters (flax names) ``rbf.freq``, ``rbf_emb`` (``num_radial ->
    ns``), ``pre_nn`` (``3 ns -> ns``), ``scalar_mlp_{0,1,2}`` (``ns -> ns
    -> ns -> 3 ns``), ``rbf_lin`` (``num_radial -> 3 ns``, no bias),
    ``post_nn`` (``21 ns -> ns``), ``update`` (PaiNN's) and the output
    embeddings."""

    feature_norm = False  # the reference PNAEqStack uses Identity feature layers

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        ns = self.node_size = in_features
        num_radial = spec.num_radial or 6
        self.last_layer = layer >= spec.num_conv_layers - 1
        self.delta = log_degree_mean(spec.pna_deg or [0, 1])
        self.avg_deg_lin = max(avg_degree_linear(spec.pna_deg or [0, 1]), 1.0)
        self.rbf = BesselBasis(num_radial, float(spec.radius or 5.0),
                               spec.envelope_exponent or 5)
        self.rbf_emb = Dense(num_radial, ns, generator)
        self.edge_encoder = Dense(spec.edge_dim, ns, generator) if spec.edge_dim else None
        self.pre_nn = Dense((4 if spec.edge_dim else 3) * ns, ns, generator)
        self.scalar_mlp_0 = Dense(ns, ns, generator)
        self.scalar_mlp_1 = Dense(ns, ns, generator)
        self.scalar_mlp_2 = Dense(ns, 3 * ns, generator)
        self.rbf_lin = Dense(num_radial, 3 * ns, generator, use_bias=False)
        self.post_nn = Dense(ns + len(AGGREGATORS) * len(PNAEQ_SCALERS) * ns, ns, generator)
        self.update = PainnUpdate(ns, self.last_layer, generator)
        output_embeddings(self, ns, out_dim or spec.hidden_dim, self.last_layer, generator)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        ns = self.node_size
        v = inv.new_zeros((batch.num_nodes, 3, ns)) if equiv.dim() == 2 else equiv
        send_idx, recv_idx = batch.views(("senders",), ("receivers",))
        vec = batch.edge_vectors(recv_idx, send_idx)
        dist = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-18)
        unit_vec = vec / (dist[:, None] + 1e-9)
        rbf = self.rbf(dist)

        feats = [edge_gather(inv, batch.senders, send_idx),
                 edge_gather(inv, batch.receivers, recv_idx), torch.tanh(self.rbf_emb(rbf))]
        if self.edge_encoder is not None:
            feats.append(self.edge_encoder(batch.edge_attr))
        h = torch.cat(feats, dim=-1)
        m = self.scalar_mlp_0(self.pre_nn(h))
        m = self.scalar_mlp_2(F.silu(self.scalar_mlp_1(torch.tanh(m))))
        m = m * self.rbf_lin(rbf)
        gate_v, gate_edge, msg_s = torch.split(m, ns, dim=-1)
        v_msg = (edge_gather(v, batch.receivers, recv_idx) * gate_v[:, None, :]
                 + gate_edge[:, None, :] * unit_vec[:, :, None])

        em = batch.edge_mask
        agg = degree_scaled_aggregate(msg_s * em[:, None], batch.senders, em, batch.num_nodes,
                                      self.delta, avg_deg_lin=self.avg_deg_lin, index=send_idx,
                                      scalers=PNAEQ_SCALERS)
        delta_x = self.post_nn(torch.cat([inv, agg], dim=-1))
        dv = edge_segment_sum(v_msg * em[:, None, None], batch.senders, batch.num_nodes,
                              index=send_idx)
        s, v = self.update(inv + delta_x, v + dv)
        return embed_outputs(self, s, v, self.last_layer)


__all__ = ["PNAEqConv"]
