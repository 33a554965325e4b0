"""CGCNN conv layer (PyG ``CGConv``): the crystal graph conv with a gated
residual update.

Counterpart of ``hydragnn_tpu/models/cgcnn.py``: ``h_i' = h_i + sum_j
sigmoid(lin_f(z_ij)) * softplus(lin_s(z_ij))`` with ``z_ij = [h_i, h_j]``.
The update is residual, so the layer keeps its input width (without GPS,
``update_config`` sets ``hidden_dim`` to the input width); a ``proj`` Dense
maps to ``out_dim`` where one is asked for. The node rows are gathered
onto the edges with ``gather_rows`` and the masked messages summed by the
segment-sum kernel over the receivers' CSR view: one launch a layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import ModelSpec
from ..graphs import segment
from ..graphs.graph import GraphBatch
from .common import Dense, gather_ends


class CGCNNConv(nn.Module):
    """Parameters ``lin_f`` and ``lin_s`` (``2 in -> in``), and ``proj``
    (``in -> out_dim``) when ``out_dim`` differs from the input width."""

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.lin_f = Dense(2 * in_features, in_features, generator)
        self.lin_s = Dense(2 * in_features, in_features, generator)
        if out_dim is not None and out_dim != in_features:
            self.proj = Dense(in_features, out_dim, generator)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.input_dim  # residual: every layer keeps the input width

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        z = torch.cat(gather_ends(inv, batch), dim=-1)
        msg = torch.sigmoid(self.lin_f(z)) * F.softplus(self.lin_s(z)) * batch.edge_mask[:, None]
        agg = segment.segment_sum(msg, batch.receivers, batch.num_nodes,
                                  index=batch.csr("receivers") if inv.is_cuda else None)
        out = inv + agg
        proj = getattr(self, "proj", None)
        return (proj(out) if proj is not None else out), equiv


__all__ = ["CGCNNConv"]
