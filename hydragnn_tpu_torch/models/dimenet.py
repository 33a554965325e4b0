"""DimeNet++ conv layer: directional message passing over edge embeddings,
the angles between edges entering through a spherical Bessel x Legendre
basis.

Counterpart of ``hydragnn_tpu/models/dimenet.py``. Per layer: a node
Linear; the embedding block (``[h[sender], h[receiver], silu(W rbf)]`` ->
edge embedding); the interaction block (triplet mixing weighted by the
spherical basis, residual layers); the output block (the rbf-gated edge
embeddings summed at their receivers, then Linears to the output width).
No feature norm. The triplets ``(idx_kj, idx_ji)`` come padded from
collate (``graphs/triplets.py``); their angles are computed here from the
edge vectors, vectors first and then the sum, so they hold under periodic
shifts.

The kernels:

* the triplet mixing ``sum_{t: ji(t) = e} x_kj[kj(t)] * sbf_e[t] *
  mask[t]`` is the gather-scatter kernel with a weight per triplet and
  channel, over the CSR view of ``idx_ji`` (sorted by construction, so
  certified and never argsorted) with edges as its rows; its backward's
  transposed launch runs over the view of ``idx_kj``;
* the output block's sum at the receivers is the segment-sum kernel;
* every gather (node rows onto edges, edge vectors onto triplets, the
  ``kj`` lengths) is ``gather_rows``, whose backward is the segment-sum
  kernel.

Pad triplets get constants in place of their vectors' dot and cross
products *before* the ``atan2`` and the ``sqrt`` (``torch.where`` sends no
gradient to the branch it does not select), and the cross product's norm
is floored, so collinear triplets get a zero gradient, not NaN: masking
after the ``atan2`` would let ``0 x NaN`` through to the forces.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import ModelSpec
from ..graphs.graph import GraphBatch
from ..ops.fused_scatter import gather_rows, gather_scatter_sum
from .common import Dense, all_edge_rows, edge_gather, edge_segment_sum, edge_shard
from .radial import BesselBasis
from .spherical import bessel_normalizers, spherical_basis, spherical_bessel_roots


class ResidualLayer(nn.Module):
    """``x + silu(lin2(silu(lin1(x))))``."""

    def __init__(self, hidden: int, generator: torch.Generator | None = None):
        super().__init__()
        self.lin1 = Dense(hidden, hidden, generator)
        self.lin2 = Dense(hidden, hidden, generator)

    def forward(self, x):
        return x + F.silu(self.lin2(F.silu(self.lin1(x))))


class InteractionPPBlock(nn.Module):
    """DimeNet++'s interaction block (PyG ``InteractionPPBlock``):
    bias-free basis transforms ``lin_rbf{1,2}`` and ``lin_sbf{1,2}``, the
    edge Linears ``lin_ji``, ``lin_kj``, ``lin_down``, ``lin_up``, ``lin``
    and the residual layers ``res_before_{i}`` and ``res_after_{i}``."""

    def __init__(self, hidden: int, num_radial: int, num_sbf: int, int_emb_size: int,
                 basis_emb_size: int, num_before_skip: int, num_after_skip: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lin_rbf1 = Dense(num_radial, basis_emb_size, generator, use_bias=False)
        self.lin_rbf2 = Dense(basis_emb_size, hidden, generator, use_bias=False)
        self.lin_sbf1 = Dense(num_sbf, basis_emb_size, generator, use_bias=False)
        self.lin_sbf2 = Dense(basis_emb_size, int_emb_size, generator, use_bias=False)
        self.lin_ji = Dense(hidden, hidden, generator)
        self.lin_kj = Dense(hidden, hidden, generator)
        self.lin_down = Dense(hidden, int_emb_size, generator)
        self.lin_up = Dense(int_emb_size, hidden, generator)
        self.num_before_skip = num_before_skip
        self.num_after_skip = num_after_skip
        for i in range(num_before_skip):
            self.add_module(f"res_before_{i}", ResidualLayer(hidden, generator))
        self.lin = Dense(hidden, hidden, generator)
        for i in range(num_after_skip):
            self.add_module(f"res_after_{i}", ResidualLayer(hidden, generator))

    def forward(self, x, rbf, sbf, batch: GraphBatch, ji_idx, kj_idx):
        rbf_e = self.lin_rbf2(self.lin_rbf1(rbf))
        sbf_e = self.lin_sbf2(self.lin_sbf1(sbf))
        x_ji = F.silu(self.lin_ji(x))
        x_kj = F.silu(self.lin_down(F.silu(self.lin_kj(x)) * rbf_e))
        # triplet mixing: edge kj's message, weighted by the angular basis,
        # summed onto edge ji (one gather-scatter launch, a weight per
        # triplet and channel; pad triplets weigh 0). The basis is fp32 (its
        # roots are), so a bf16 step mixes in fp32, as jnp promotes it.
        # Under edge sharding this rank's triplets feed its own ji edges
        # and read kj edges of every rank: the messages of all edges,
        # gathered (their gradient summed over the ranks, then each rank's
        # block)
        weight = sbf_e * batch.triplet_mask[:, None]
        dtype = torch.promote_types(x_kj.dtype, weight.dtype)
        x_kj = all_edge_rows(x_kj.to(dtype))
        x_kj = gather_scatter_sum(x_kj, batch.idx_kj, batch.idx_ji, batch.num_edges,
                                  weight=weight.to(dtype), index=ji_idx, send_index=kj_idx)
        h = x_ji + F.silu(self.lin_up(x_kj))
        for i in range(self.num_before_skip):
            h = getattr(self, f"res_before_{i}")(h)
        h = F.silu(self.lin(h)) + x
        for i in range(self.num_after_skip):
            h = getattr(self, f"res_after_{i}")(h)
        return h


class DimeNetConv(nn.Module):
    """One DimeNet++ layer. Parameters (flax names): ``rbf.freq``,
    ``lin_node``, ``emb_lin_rbf``, ``emb_lin`` (which reads the edge
    features too, where there are any), ``interaction`` (its block),
    ``out_lin_rbf``, ``out_lin_up``, ``out_lin_0`` and ``out_lin``.
    The spherical Bessel roots and normalisers are float32 buffers outside
    the state dict."""

    feature_norm = False  # the reference DIMEStack uses Identity feature layers

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        hidden = max(spec.hidden_dim, 2)
        out_dim = out_dim or spec.hidden_dim
        num_radial = spec.num_radial or 6
        num_spherical = spec.num_spherical or 7
        out_emb = spec.out_emb_size or 128
        self.cutoff = float(spec.radius or 5.0)
        self.envelope_exponent = spec.envelope_exponent or 5
        self.register_buffer("sbf_roots", torch.from_numpy(
            spherical_bessel_roots(num_spherical, num_radial).astype(np.float32)),
            persistent=False)
        self.register_buffer("sbf_norms", torch.from_numpy(
            bessel_normalizers(num_spherical, num_radial).astype(np.float32)), persistent=False)
        self.rbf = BesselBasis(num_radial, self.cutoff, self.envelope_exponent)
        self.lin_node = Dense(in_features, hidden, generator)
        self.emb_lin_rbf = Dense(num_radial, hidden, generator)
        self.edge_dim = spec.edge_dim
        self.emb_lin = Dense(3 * hidden + self.edge_dim, hidden, generator)
        self.interaction = InteractionPPBlock(
            hidden, num_radial, num_spherical * num_radial, spec.int_emb_size or 64,
            spec.basis_emb_size or 8, spec.num_before_skip or 1, spec.num_after_skip or 2,
            generator)
        self.out_lin_rbf = Dense(num_radial, hidden, generator, use_bias=False)
        self.out_lin_up = Dense(hidden, out_emb, generator, use_bias=False)
        self.out_lin_0 = Dense(out_emb, out_emb, generator)
        self.out_lin = Dense(out_emb, out_dim, generator, use_bias=False)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        if batch.idx_kj.shape[0] == 0:
            raise ValueError("DimeNet needs triplet indices; attach them in preprocessing "
                             "(hydragnn_tpu_torch.graphs.triplets.attach_triplets)")
        # the receivers' view carries the output sum, the senders' the
        # backward of the gathers by sender; the triplet views carry the
        # mixing (idx_ji) and its backward (idx_kj), which every layer takes
        # in training (lin_kj sits in front of the mixing)
        shard = edge_shard()
        recv_idx, ji_idx, send_idx, kj_idx = batch.views(("receivers", "idx_ji"),
                                                         ("senders", "idx_kj"), shard)

        vec = batch.edge_vectors(recv_idx, send_idx)
        dist = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-18)

        # the angle at the shared vertex j of each triplet (module docstring);
        # under edge sharding its kj edge may be another rank's
        tm = batch.triplet_mask > 0
        vec_all = all_edge_rows(vec)
        dist_all = torch.sqrt(torch.sum(vec_all * vec_all, dim=-1) + 1e-18)
        pos_ji = gather_rows(vec, batch.idx_ji, ji_idx)
        pos_kj = gather_rows(vec_all, batch.idx_kj, kj_idx)
        pos_ki = pos_kj + pos_ji
        a = torch.where(tm, torch.sum(pos_ji * pos_ki, dim=-1), torch.ones_like(tm, dtype=vec.dtype))
        cr = torch.linalg.cross(pos_ji, pos_ki, dim=-1)
        b2 = torch.sum(cr * cr, dim=-1)
        b = torch.sqrt(torch.maximum(b2, torch.full_like(b2, 1e-18)))
        b = torch.where(tm, b, torch.zeros_like(b))
        angle = torch.atan2(b, a)

        rbf = self.rbf(dist)
        sbf = spherical_basis(gather_rows(dist_all, batch.idx_kj, kj_idx), angle, self.sbf_roots,
                              self.sbf_norms, self.cutoff, self.envelope_exponent)

        h = self.lin_node(inv)
        feats = [edge_gather(h, batch.senders, send_idx), edge_gather(h, batch.receivers, recv_idx),
                 F.silu(self.emb_lin_rbf(rbf))]
        if self.edge_dim:
            feats.append(batch.edge_attr)
        x_edge = F.silu(self.emb_lin(torch.cat(feats, dim=-1)))
        x_edge = self.interaction(x_edge, rbf, sbf, batch, ji_idx, kj_idx)

        x_gated = self.out_lin_rbf(rbf) * x_edge * batch.edge_mask[:, None]
        node_x = edge_segment_sum(x_gated, batch.receivers, batch.num_nodes, index=recv_idx)
        node_x = F.silu(self.out_lin_0(self.out_lin_up(node_x)))
        return self.out_lin(node_x), equiv


__all__ = ["DimeNetConv", "InteractionPPBlock", "ResidualLayer"]
