"""CGCNN conv layer (PyG ``CGConv``): the crystal graph conv with a gated
residual update.

Counterpart of ``hydragnn_tpu/models/cgcnn.py``: ``h_i' = h_i + sum_j
sigmoid(lin_f(z_ij)) * softplus(lin_s(z_ij))`` with ``z_ij = [h_i, h_j,
e_ij]`` (the edge features where there are any). The update is residual,
so the layer keeps its input width: without GPS ``update_config`` sets
``hidden_dim`` to the input width, under GPS every layer reads (and keeps)
``hidden_dim``; a ``proj`` Dense
maps to ``out_dim`` where one is asked for. The node rows are gathered
onto the edges with ``gather_rows`` and the masked messages summed by the
segment-sum kernel over the receivers' CSR view: one launch a layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import ModelSpec
from ..graphs.graph import GraphBatch
from .common import Dense, edge_segment_sum, gather_ends


class CGCNNConv(nn.Module):
    """Parameters ``lin_f`` and ``lin_s`` (``2 in + edge_dim -> in``), and ``proj``
    (``in -> out_dim``) when ``out_dim`` differs from the input width."""

    keeps_width = True  # a conv node head's layers keep the heads' input width

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.edge_dim = spec.edge_dim
        z_width = 2 * in_features + self.edge_dim
        self.lin_f = Dense(z_width, in_features, generator)
        self.lin_s = Dense(z_width, in_features, generator)
        if out_dim is not None and out_dim != in_features:
            self.proj = Dense(in_features, out_dim, generator)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        # residual: every layer keeps its input width, which GPS's
        # embedding makes hidden_dim
        return spec.hidden_dim if spec.global_attn_engine else spec.input_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        ends = gather_ends(inv, batch)
        z = torch.cat([*ends, batch.edge_attr] if self.edge_dim else ends, dim=-1)
        msg = torch.sigmoid(self.lin_f(z)) * F.softplus(self.lin_s(z)) * batch.edge_mask[:, None]
        agg = edge_segment_sum(msg, batch.receivers, batch.num_nodes,
                               index=batch.csr("receivers") if inv.is_cuda else None)
        out = inv + agg
        proj = getattr(self, "proj", None)
        return (proj(out) if proj is not None else out), equiv


__all__ = ["CGCNNConv"]
