"""GIN — Graph Isomorphism Network conv layer.

Counterpart of ``hydragnn_tpu/models/gin.py`` (PyG ``GINConv`` with
``train_eps=True``): ``MLP((1 + eps) * h_i + sum_j h_j)``, the neighbour sum
taken by the CSR gather-scatter kernel with the edge mask as the per-edge
weight. Positions pass through untouched. ``eps`` is trainable.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..graphs.graph import GraphBatch
from .common import MLP, neighbour_sum


class GINConv(nn.Module):
    """Parameters: ``eps`` (0-d, init 0) and ``nn`` = MLP(hidden, hidden)."""

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        hidden = out_dim or spec.hidden_dim
        self.eps = nn.Parameter(torch.zeros(()))
        self.nn = MLP(in_features, (hidden, hidden), activation=spec.activation,
                      generator=generator)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        # the sum before the other use of inv: the order in which a tensor's
        # uses are created sets the order in which autograd adds their
        # gradients, and GPS's trained bits (its int8 gates) depend on it
        agg = neighbour_sum(inv, batch)
        return self.nn((1.0 + self.eps) * inv + agg), equiv


__all__ = ["GINConv"]
