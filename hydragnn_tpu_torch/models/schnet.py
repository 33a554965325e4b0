"""SchNet conv layer: the continuous-filter convolution.

Counterpart of ``hydragnn_tpu/models/schnet.py``. Per layer, over each edge
``j -> i`` of length ``d_ij``:

    W_ij = filter2(ssp(filter1(gauss(d_ij)))) * C(d_ij)
    h_i' = lin2(sum_j W_ij * lin1(h_j))

with ``gauss`` the Gaussian smearing on ``[0, radius]``, ``ssp`` the shifted
softplus and ``C`` the cosine cutoff. The sum is the CSR gather-scatter
kernel with a weight per edge and channel (``[E, num_filters]``, the
filters times the edge mask): its gradient with respect to the filters,
``dW = lin1(h)[s] * dout[r]``, is taken beside the kernel's transposed
launch, which every layer runs (``lin1`` sits in front of the sum). The
stack has no feature norm (``feature_norm = False``).

With ``equivariance``, every layer but the last also moves the positions by
the sender-mean of ``vec / (d + 1)`` gated by an MLP of the filters
(``coord_mlp_0``/``coord_mlp_out``, no tanh bound;
``common.equivariant_coordinate_update``). The positions are gathered onto
the edges with ``gather_rows``, whose backward is the segment-sum kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..graphs.graph import GraphBatch
from ..ops.fused_scatter import gather_scatter_sum
from .common import (Dense, coordinate_update_layers, edge_gather, enter_edges,
                     equivariant_coordinate_update, exit_edges)
from .radial import GaussianSmearing, cosine_cutoff, shifted_softplus


class SchNetConv(nn.Module):
    """Parameters (the flax names) ``filter1`` (``num_gaussians + edge_dim
    -> num_filters``: the Gaussian expansion, then the edge features), ``filter2`` (``num_filters -> num_filters``), ``lin1``
    (``in -> num_filters``, no bias), ``lin2`` (``num_filters -> hidden``)
    and, on equivariant layers, ``coord_mlp_0``/``coord_mlp_out``."""

    feature_norm = False  # the reference SCFStack uses Identity feature layers

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        hidden = out_dim or spec.hidden_dim
        nf = spec.num_filters or 64
        self.cutoff = float(spec.radius or 5.0)
        self.equivariant = bool(spec.equivariance) and layer < spec.num_conv_layers - 1
        self.smearing = GaussianSmearing(0.0, self.cutoff, spec.num_gaussians or 50)
        self.edge_dim = spec.edge_dim
        self.filter1 = Dense((spec.num_gaussians or 50) + self.edge_dim, nf, generator)
        self.filter2 = Dense(nf, nf, generator)
        self.lin1 = Dense(in_features, nf, generator, use_bias=False)
        self.lin2 = Dense(nf, hidden, generator)
        if self.equivariant:
            coordinate_update_layers(self, nf, "coord", generator)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        n, s, r = batch.num_nodes, batch.senders, batch.receivers
        on_card = inv.is_cuda
        # the receivers' view carries the sum, the senders' view its
        # transposed launch (every layer's, in training) and the coordinate
        # update's sender mean
        recv_idx = batch.csr("receivers") if on_card else None
        send_idx = (batch.csr("senders")
                    if on_card and (self.equivariant or torch.is_grad_enabled()) else None)

        vec = edge_gather(equiv, r, recv_idx) - edge_gather(equiv, s, send_idx) + batch.edge_shifts
        dist = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-12)
        rbf = self.smearing(dist)
        if self.edge_dim:
            rbf = torch.cat([rbf, batch.edge_attr], dim=-1)
        w = self.filter2(shifted_softplus(self.filter1(rbf)))
        w = w * cosine_cutoff(dist, self.cutoff)[:, None]

        x = enter_edges(self.lin1(inv))
        agg = exit_edges(gather_scatter_sum(x, s, r, n,
                                            weight=(w * batch.edge_mask[:, None]).to(x.dtype),
                                            index=recv_idx, send_index=send_idx))
        out = self.lin2(agg)
        if self.equivariant:
            coord_diff = vec / (dist[:, None] + 1.0)
            equiv = equiv + equivariant_coordinate_update(
                self, w, coord_diff, s, batch.edge_mask, n, tanh_bound=False, prefix="coord",
                send_index=send_idx)
        return out, equiv


__all__ = ["SchNetConv"]
