"""GraphSAGE conv layer (PyG ``SAGEConv``, mean aggregation).

Counterpart of ``hydragnn_tpu/models/sage.py``: ``lin_root(h_i) +
lin_nbr(mean_j h_j)``. The neighbour sum is the CSR gather-scatter kernel
with the edge mask as the per-edge weight, divided by the masked in-degree
(clamped at 1e-12, so a node without edges gets 0). Positions pass through.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..graphs import segment
from ..graphs.graph import GraphBatch
from .common import Dense, neighbour_sum


class SAGEConv(nn.Module):
    """Parameters ``lin_root`` and ``lin_nbr`` (``in -> hidden``)."""

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        hidden = out_dim or spec.hidden_dim
        self.lin_root = Dense(in_features, hidden, generator)
        self.lin_nbr = Dense(in_features, hidden, generator)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        total = neighbour_sum(inv, batch)
        count = segment.segment_count(batch.receivers, batch.num_nodes, weights=batch.edge_mask)
        agg = total / torch.clamp(count, min=1e-12).to(total.dtype)[:, None]
        return self.lin_root(inv) + self.lin_nbr(agg), equiv


__all__ = ["SAGEConv"]
