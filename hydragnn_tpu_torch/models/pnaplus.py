"""PNAPlus conv layer: PNA with Bessel radial embeddings of the edge
lengths.

Counterpart of ``hydragnn_tpu/models/pnaplus.py``: messages ``pre_nn([h_i,
h_j, relu(rbf_emb(rbf))])`` (with edge features, the last block is
``edge_encoder([e_ij, relu(rbf_emb(rbf))])``), gated elementwise by ``rbf_lin(rbf)``, then
PNA's degree-scaled aggregate (``models/pna.py``: three segment-sum
launches a layer) and ``lin(post_nn([h_i, aggregates]))``. ``rbf`` is the
Bessel basis of the edge lengths, with trainable frequencies (flax
``rbf.freq``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import ModelSpec
from ..graphs.graph import GraphBatch
from .common import Dense, gather_ends
from .pna import (AGGREGATORS, SCALERS, avg_degree_linear, degree_scaled_aggregate,
                  log_degree_mean)
from .radial import BesselBasis


class PNAPlusConv(nn.Module):
    """Parameters ``rbf.freq`` (``num_radial``), ``rbf_emb`` (``num_radial
    -> in``), with edge features ``edge_encoder`` (``edge_dim + in -> in``),
    ``pre_nn`` (``3 in -> in``), ``rbf_lin`` (``num_radial -> in``, no bias),
    ``post_nn`` (``17 in -> hidden``) and ``lin``."""

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        hidden = out_dim or spec.hidden_dim
        f = in_features
        num_radial = spec.num_radial or 6
        self.delta = log_degree_mean(spec.pna_deg or [0, 1])
        self.avg_deg_lin = avg_degree_linear(spec.pna_deg or [0, 1])
        self.rbf = BesselBasis(num_radial, spec.radius or 5.0, spec.envelope_exponent or 5)
        self.rbf_emb = Dense(num_radial, f, generator)
        self.edge_encoder = (Dense(spec.edge_dim + f, f, generator) if spec.edge_dim
                             else None)
        self.pre_nn = Dense(3 * f, f, generator)
        self.rbf_lin = Dense(num_radial, f, generator, use_bias=False)
        self.post_nn = Dense(f + len(AGGREGATORS) * len(SCALERS) * f, hidden, generator)
        self.lin = Dense(hidden, hidden, generator)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        rbf = self.rbf(batch.edge_lengths().reshape(-1))
        ea = F.relu(self.rbf_emb(rbf))
        if self.edge_encoder is not None:
            ea = self.edge_encoder(torch.cat([batch.edge_attr, ea], dim=-1))
        h = torch.cat([*gather_ends(inv, batch), ea], dim=-1)
        msg = self.pre_nn(h) * self.rbf_lin(rbf)
        agg = degree_scaled_aggregate(
            msg, batch.receivers, batch.edge_mask, batch.num_nodes, self.delta,
            avg_deg_lin=self.avg_deg_lin,
            index=batch.csr("receivers") if inv.is_cuda else None)
        out = self.post_nn(torch.cat([inv, agg], dim=-1))
        return self.lin(out), equiv


__all__ = ["PNAPlusConv"]
