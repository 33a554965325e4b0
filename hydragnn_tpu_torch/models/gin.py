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
from ..ops.fused_scatter import gather_scatter_sum
from .common import MLP


class GINConv(nn.Module):
    """Parameters: ``eps`` (0-d, init 0) and ``nn`` = MLP(hidden, hidden)."""

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        hidden = out_dim or spec.hidden_dim
        self.eps = nn.Parameter(torch.zeros(()))
        self.nn = MLP(in_features, (hidden, hidden), activation=spec.activation,
                      generator=generator)

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch):
        # the kernels read the batch's cached CSR views: the receivers' for
        # the forward, the senders' for the gradient with respect to inv
        # (built only where that gradient is taken; conv layer 0's input
        # needs none)
        on_card = inv.is_cuda
        agg = gather_scatter_sum(
            inv, batch.senders, batch.receivers, batch.num_nodes,
            weight=batch.edge_mask.to(inv.dtype),
            index=batch.csr("receivers") if on_card else None,
            send_index=(batch.csr("senders")
                        if on_card and inv.requires_grad and torch.is_grad_enabled() else None),
        )
        return self.nn((1.0 + self.eps) * inv + agg), equiv


__all__ = ["GINConv"]
