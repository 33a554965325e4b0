"""MFC conv layer (PyG ``MFConv``, the molecular fingerprint conv of
Duvenaud et al.).

Counterpart of ``hydragnn_tpu/models/mfc.py``: ``h_i' = h_i W_root[d_i] +
(sum_j h_j) W_nbr[d_i] + b[d_i]`` with a weight pair and a bias per
in-degree ``d_i``, clamped to ``[0, max_neighbours]`` (10 when unset). The
neighbour sum is the CSR gather-scatter kernel; under edge sharding the sum
and the degree are every rank's.

The JAX package gathers the banks by degree (``w_root[deg]``, ``[N, in,
hidden]``) and contracts per node. In PyTorch that gather would build a
``[N, in, hidden]`` tensor (30 MB per layer at the qm9 top bucket) whose
backward is an accumulating ``index_put_``. The port computes the same
function as one product: the one-hot of the clamped degree times the node
row, ``[N, (max_deg + 1) * in]``, against the bank flattened to ``[(max_deg
+ 1) * in, hidden]``. Every other degree's block meets zeros, so each
output sums the same nonzero terms as the einsum, in the product's order.
The bias is the one-hot times ``b``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..graphs.graph import GraphBatch
from .common import edge_segment_count, lecun_normal_, neighbour_sum


def degree_bank_product(x: torch.Tensor, onehot: torch.Tensor,
                        bank: torch.Tensor) -> torch.Tensor:
    """``einsum("ni,nio->no", x, bank[deg])`` for ``onehot = one_hot(deg)``
    (``[N, D]``, bool or float) and ``bank`` ``[D, in, out]``, as one
    matrix product (types promoted as ``jnp.einsum`` promotes)."""
    dtype = torch.promote_types(x.dtype, bank.dtype)
    n, d = onehot.shape
    rows = (onehot.to(dtype)[:, :, None] * x.to(dtype)[:, None, :]).reshape(n, -1)
    return rows @ bank.to(dtype).reshape(d * bank.shape[1], bank.shape[2])


class MFCConv(nn.Module):
    """Parameters (the flax names) ``w_root`` and ``w_nbr`` ``[max_deg + 1,
    in, hidden]`` (flax's lecun-normal, fan-in ``(max_deg + 1) * in``) and
    ``bias`` ``[max_deg + 1, hidden]`` (zeros)."""

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        hidden = out_dim or spec.hidden_dim
        self.max_deg = int(spec.max_neighbours or 10)
        banks = self.max_deg + 1
        self.w_root = nn.Parameter(torch.empty(banks, in_features, hidden))
        self.w_nbr = nn.Parameter(torch.empty(banks, in_features, hidden))
        self.bias = nn.Parameter(torch.zeros(banks, hidden))
        for w in (self.w_root, self.w_nbr):
            # flax's lecun_normal on [D, in, out] takes the fan-in over
            # the input axis and the leading (receptive-field) axis: D * in
            lecun_normal_(w, generator, fan_in=banks * in_features)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        agg = neighbour_sum(inv, batch)
        deg = edge_segment_count(batch.receivers, batch.num_nodes, weights=batch.edge_mask)
        deg_idx = torch.clamp(deg.to(torch.int64), 0, self.max_deg)
        # the one-hot as a comparison: nothing here waits for the host
        onehot = deg_idx[:, None] == torch.arange(self.max_deg + 1, device=deg_idx.device)
        out = (degree_bank_product(inv, onehot, self.w_root)
               + degree_bank_product(agg, onehot, self.w_nbr))
        dtype = torch.promote_types(out.dtype, self.bias.dtype)
        return out.to(dtype) + onehot.to(dtype) @ self.bias.to(dtype), equiv


__all__ = ["MFCConv", "degree_bank_product"]
