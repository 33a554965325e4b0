"""PNA conv layer (PyG ``PNAConv``): Principal Neighbourhood Aggregation.

Counterpart of ``hydragnn_tpu/models/pna.py``. Messages ``pre_nn([h_i,
h_j])`` over each edge ``j -> i`` are aggregated four ways (mean, min, max,
std) and each aggregate scaled four ways by the in-degree (identity,
amplification, attenuation, linear), calibrated on the training set's
degree histogram ``pna_deg``; then ``lin(post_nn([h_i, aggregates]))``.

The node rows are gathered onto the edges with ``gather_rows`` (backward:
the segment-sum kernel, no atomics). The mean and the two means of the std
are the segment-sum kernel over the receivers' CSR view: three launches a
layer. Min and max are ``scatter_reduce`` (plain PyTorch, as the JAX
package leaves them to XLA), whose gradient is split evenly among tied
extremes, as JAX's is.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config.schema import ModelSpec
from ..graphs.graph import GraphBatch
from ..ops.fused_scatter import SegmentIndex
from .common import (Dense, edge_segment_count, edge_segment_extreme, edge_segment_mean,
                     edge_segment_std, gather_ends)

AGGREGATORS = ("mean", "min", "max", "std")
SCALERS = ("identity", "amplification", "attenuation", "linear")
# PNAEq's scalers: PNA's and ``inverse_linear`` (``avg_deg_lin / d``)
PNAEQ_SCALERS = SCALERS + ("inverse_linear",)


def avg_degree_linear(deg_hist) -> float:
    """The histogram's mean degree: the ``linear`` scaler's normaliser."""
    hist = np.asarray(deg_hist, np.float64)
    d = np.arange(len(hist))
    total = hist.sum()
    return float((d * hist).sum() / total) if total else 1.0


def log_degree_mean(deg_hist) -> float:
    """``delta = E[log(d + 1)]`` over the histogram: the amplification and
    attenuation scalers' normaliser."""
    hist = np.asarray(deg_hist, np.float64)
    d = np.arange(len(hist))
    total = hist.sum()
    if total == 0:
        return 1.0
    return float((np.log(d + 1) * hist).sum() / total)


def degree_scaled_aggregate(msg: torch.Tensor, receivers: torch.Tensor,
                            edge_mask: torch.Tensor, num_nodes: int, delta: float,
                            avg_deg_lin: float,
                            index: SegmentIndex | None = None,
                            scalers: tuple = SCALERS) -> torch.Tensor:
    """``[E, F]`` messages -> ``[N, 4 S F]``: the ``AGGREGATORS`` (mean,
    min, max, std), each under the ``S`` ``scalers`` (by default PNA's
    ``SCALERS``: identity, amplification ``log(d + 1) / delta``, attenuation
    ``delta / log(d + 1)``, linear ``d / avg_deg_lin``; PNAEq adds
    inverse_linear ``avg_deg_lin / d``).

    Pad edges point at the dummy node, so the real nodes' statistics see
    real edges only; the mean takes the masked messages. The degree is
    clamped at 1 before the scalers (a node without edges would otherwise
    be attenuated by ``delta / log 1``). ``receivers`` are the ids the
    messages aggregate by (PNAEq's: the senders); ``index``: their CSR view
    for the segment sums. Under edge sharding every statistic is every
    rank's: the sums and counts summed before the divisions, the extremes
    reduced before their non-finite results become 0."""
    deg = edge_segment_count(receivers, num_nodes, weights=edge_mask)
    agg = torch.cat([
        edge_segment_mean(msg * edge_mask[:, None], receivers, num_nodes, index=index),
        edge_segment_extreme(msg, receivers, num_nodes, "min"),
        edge_segment_extreme(msg, receivers, num_nodes, "max"),
        edge_segment_std(msg, receivers, num_nodes, index=index),
    ], dim=-1)
    deg_c = torch.clamp(deg, min=1.0)
    log_deg = torch.log(deg_c + 1.0)
    # a python float over a tensor is a multiply by the reciprocal in torch;
    # jnp divides
    scale = {
        "amplification": lambda: log_deg / delta,
        "attenuation": lambda: torch.full_like(log_deg, delta) / log_deg,
        "linear": lambda: deg_c / max(avg_deg_lin, 1e-6),
        "inverse_linear": lambda: torch.full_like(deg_c, avg_deg_lin) / deg_c,
    }
    return torch.cat([agg if s == "identity" else agg * scale[s]()[:, None] for s in scalers],
                     dim=-1)


class PNAConv(nn.Module):
    """Parameters ``pre_nn`` (``2 in + edge_dim -> in``: both ends' rows and
    the edge features), ``post_nn`` (``17 in -> hidden``: the input and its
    16 scaled aggregates) and ``lin``."""


    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        hidden = out_dim or spec.hidden_dim
        f = in_features
        self.delta = log_degree_mean(spec.pna_deg or [0, 1])
        self.avg_deg_lin = avg_degree_linear(spec.pna_deg or [0, 1])
        self.edge_dim = spec.edge_dim
        self.pre_nn = Dense(2 * f + self.edge_dim, f, generator)
        self.post_nn = Dense(f + len(AGGREGATORS) * len(SCALERS) * f, hidden, generator)
        self.lin = Dense(hidden, hidden, generator)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        ends = gather_ends(inv, batch)
        msg = self.pre_nn(torch.cat([*ends, batch.edge_attr] if self.edge_dim else ends, dim=-1))
        agg = degree_scaled_aggregate(
            msg, batch.receivers, batch.edge_mask, batch.num_nodes, self.delta,
            avg_deg_lin=self.avg_deg_lin,
            index=batch.csr("receivers") if inv.is_cuda else None)
        out = self.post_nn(torch.cat([inv, agg], dim=-1))
        return self.lin(out), equiv


__all__ = ["AGGREGATORS", "PNAConv", "PNAEQ_SCALERS", "SCALERS", "avg_degree_linear", "degree_scaled_aggregate",
           "log_degree_mean"]
