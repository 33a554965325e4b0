"""MACE conv layer: higher-order equivariant message passing over irreps
features ``{l: [N, 2l+1, C]}``.

Counterpart of ``hydragnn_tpu/models/mace.py`` (the JAX package's own
design, not a weight-for-weight port of the reference's MACEStack). Per
layer:

* node features as irreps: on the first layer ``{0: node_embedding(x)}``
  (it receives the positions as ``equiv``), later ``{0: inv}`` and the
  packed ``l >= 1`` blocks; ``linear_up`` (a per-``l`` channel mix, bias on
  ``l = 0`` only);
* element gate: an embedding of the raw atomic numbers ``batch.z`` over 119
  rows (``element_embed``);
* interaction: the edge directions' real spherical harmonics up to
  ``max_ell``; a radial MLP of the edge lengths' basis (times the
  polynomial cutoff) gives a weight per edge, path and channel; the
  senders' features times the harmonics through the Gaunt tensor product,
  summed at the receivers over ``avg_num_neighbors``; ``linear_post``;
* residual: ``skip_tp`` of the input features, element-gated;
* product basis: ``B_1 = A``, ``B_nu = TP(B_{nu-1}, A)`` with learned
  per-path weights ``prod_w{nu}_{l1}{l2}{l3}``, each through
  ``prod_linear_{nu}``, element-gated and summed;
* ``sizing`` to the output width; the scalars are the layer's invariant
  output, the ``l >= 1`` blocks its packed equivariant output (the last
  layer returns scalars only).

No feature norm and no activation between layers (``stack_activation =
False``); the heads read every layer's scalars, concatenated
(``collect_layer_outputs = True``). MACE is among the ``EDGE_MODELS`` but
reads no edge features, as the JAX package's: ``edge_attr`` (GPS's relative
encodings included) leaves its outputs unchanged.

On the card each ``l`` block's message sum is one launch of the
segment-sum kernel over the receivers' CSR view, ``[E, 2l+1, C]``
flattened to ``[E, (2l+1) C]`` and summed in fp32; the gathers (sender
features, positions, the element embedding by ``z``) are ``gather_rows``,
whose backward is the segment-sum kernel. The Gaunt tables are buffers
made once per layer (``harmonics.gaunt_buffers``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import ModelSpec
from ..graphs import segment
from ..graphs.graph import NUM_ELEMENTS, GraphBatch
from ..ops.fused_scatter import gather_rows
from .common import Dense, lecun_normal_
from .harmonics import (coupling_paths, gaunt_buffers, gaunt_name, spherical_harmonics,
                        tensor_product)
from .radial import BesselBasis, ChebyshevBasis, GaussianSmearing, polynomial_cutoff


def _pack_equiv(feats: dict, l_max: int) -> torch.Tensor:
    """``{l: [N, 2l+1, C]}`` for ``l = 1 .. l_max`` -> ``[N, sum(2l+1), C]``
    (3-D on purpose: a layer tells the first layer's positions ``[N, 3]``
    from packed features by their rank)."""
    return torch.cat([feats[l] for l in range(1, l_max + 1)], dim=1)


def _unpack_equiv(equiv: torch.Tensor, l_max: int) -> dict:
    feats, off = {}, 0
    for l in range(1, l_max + 1):
        feats[l] = equiv[:, off : off + 2 * l + 1, :]
        off += 2 * l + 1
    return feats


class IrrepsLinear(nn.Module):
    """The per-``l`` channel mix (e3nn ``o3.Linear``): block ``l`` gets its
    own ``[C_in, C_out]`` matrix ``w{l}`` (flax's layout, lecun-normal), and
    ``l = 0`` a bias ``b0`` when ``bias``. Only the blocks given are mixed;
    ``in_channels`` maps each ``l`` this module holds to its width."""

    def __init__(self, in_channels: dict, channels: int, bias: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        for l, c_in in in_channels.items():
            w = nn.Parameter(torch.empty(c_in, channels))
            lecun_normal_(w, generator, fan_in=c_in)
            self.register_parameter(f"w{l}", w)
        if bias and 0 in in_channels:
            self.b0 = nn.Parameter(torch.zeros(channels))

    def forward(self, feats: dict) -> dict:
        out = {}
        for l in sorted(feats):
            w = getattr(self, f"w{l}", None)
            if w is None:
                continue
            x = feats[l]
            dtype = torch.promote_types(x.dtype, w.dtype)
            y = torch.matmul(x.to(dtype), w.to(dtype))
            if l == 0 and hasattr(self, "b0"):
                y = y + self.b0.to(dtype)
            out[l] = y
        return out


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of ``embedding [num, features]`` by index,
    gathered with ``gather_rows`` (its backward: the segment-sum kernel over
    ``index``, no atomics)."""

    def __init__(self, num: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))
        with torch.no_grad():
            self.embedding.normal_(0.0, math.sqrt(1.0 / features), generator=generator)

    def forward(self, ids: torch.Tensor, index=None) -> torch.Tensor:
        return gather_rows(self.embedding, ids, index)


class MACEConv(nn.Module):
    """One MACE layer; parameters by their flax names (module docstring).
    The Gaunt tables of the interaction and product paths are buffers
    outside the state dict."""

    feature_norm = False  # the reference applies no batch norm between MACE layers
    stack_activation = False  # nor an activation
    collect_layer_outputs = True  # the heads read every layer's scalars

    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        c = self.channels = max(spec.hidden_dim, 2)
        out_c = out_dim or spec.hidden_dim
        self.max_ell = 1 if spec.max_ell is None else spec.max_ell
        self.node_ell = node_ell = 1 if spec.node_max_ell is None else spec.node_max_ell
        self.last_layer = layer >= spec.num_conv_layers - 1
        self.first_layer = layer == 0
        self.out_ell = 0 if self.last_layer else node_ell
        correlation = 2 if spec.correlation is None else spec.correlation
        if isinstance(correlation, (list, tuple)):
            correlation = int(correlation[min(layer, len(correlation) - 1)])
        self.correlation = correlation
        self.avg_nbr = float(spec.avg_num_neighbors or 1.0)
        self.r_max = float(spec.radius or 5.0)
        num_radial = spec.num_radial or 8

        # blocks of the input: the first layer's scalars are embedded; later
        # layers read the previous layer's scalars and its packed l >= 1
        if self.first_layer:
            self.node_embedding = Dense(in_features, c, generator)
            in_ch = {0: c}
        else:
            in_ch = {l: in_features for l in range(node_ell + 1)}
        self.linear_up = IrrepsLinear(in_ch, c, bias=True, generator=generator)
        self.element_embed = Embed(NUM_ELEMENTS, c, generator)
        rt = (spec.radial_type or "bessel").lower()
        if rt == "bessel":
            self.rbf = BesselBasis(num_radial, self.r_max)
        elif rt == "chebyshev":
            self.rbf = ChebyshevBasis(num_radial, self.r_max)
        elif rt == "gaussian":
            self.rbf = GaussianSmearing(0.0, self.r_max, num_radial)
        else:
            raise ValueError(f"unknown radial_type '{rt}'")
        # the messages keep l <= node_ell on the last layer too: the product
        # basis needs them before the sizing trims to scalars
        self.paths = coupling_paths(node_ell, self.max_ell, node_ell)
        rm = max(math.ceil(c / 3.0), 4)  # radial_MLP = [ceil(C/3)] * 3
        d = num_radial
        for i in range(3):
            self.add_module(f"radial_mlp_{i}", Dense(d, rm, generator))
            d = rm
        self.radial_out = Dense(rm, len(self.paths) * c, generator, use_bias=False)
        # the blocks the messages reach: u (the senders' features) holds
        # l <= node_ell on later layers, l = 0 on the first
        msg_ls = sorted({p[2] for p in self.paths if not self.first_layer or p[0] == 0})
        self.linear_post = IrrepsLinear({l: c for l in msg_ls}, c, generator=generator)
        self.skip_tp = IrrepsLinear({l: c for l in in_ch}, c, generator=generator)
        self.prod_paths = coupling_paths(node_ell, node_ell, node_ell)
        prod_ls = set(msg_ls)
        for nu in range(1, correlation + 1):
            if nu > 1:
                for p in self.prod_paths:
                    w = nn.Parameter(torch.empty(c))
                    with torch.no_grad():
                        w.normal_(0.0, 1.0 / math.sqrt(nu), generator=generator)
                    self.register_parameter(f"prod_w{nu}_{p[0]}{p[1]}{p[2]}", w)
                prod_ls = {p[2] for p in self.prod_paths if p[0] in prod_ls and p[1] in msg_ls}
            self.add_module(f"prod_linear_{nu}", IrrepsLinear(
                {l: c for l in sorted(prod_ls)}, c, generator=generator))
        self.sizing = IrrepsLinear({l: c for l in range(self.out_ell + 1)}, out_c,
                                   generator=generator)
        gaunt_buffers(self, sorted(set(self.paths) | set(self.prod_paths)))

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        return spec.hidden_dim

    def _table(self, path):
        return getattr(self, gaunt_name(path))

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        c, node_ell = self.channels, self.node_ell
        recv_idx, send_idx, elem_idx = batch.views(("receivers",), ("senders", "elements"))

        if self.first_layer:
            feats = {0: self.node_embedding(inv)[:, None, :]}
        else:
            feats = {0: inv[:, None, :]}
            feats.update(_unpack_equiv(equiv, node_ell))
        feats = self.linear_up(feats)

        # raw atomic numbers (collected before the features' normalisation)
        z = torch.clamp(batch.z.to(torch.int32), 0, NUM_ELEMENTS - 1)
        elem_gate = self.element_embed(z, elem_idx)

        vec = batch.edge_vectors(recv_idx, send_idx)
        dist = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-18)
        y = spherical_harmonics(vec, self.max_ell)
        rbf = self.rbf(dist) * polynomial_cutoff(dist, self.r_max)[:, None]

        h = rbf
        for i in range(3):
            h = F.silu(getattr(self, f"radial_mlp_{i}")(h))
        path_w = self.radial_out(h).reshape(-1, len(self.paths), c)  # [E, P, C]

        sender_feats = {l: gather_rows(f, batch.senders, send_idx) for l, f in feats.items()}
        sh = {l: y[l][:, :, None] for l in range(self.max_ell + 1)}
        em = batch.edge_mask[:, None, None]
        weights = {p: path_w[:, i, None, :] * em for i, p in enumerate(self.paths)}
        msgs = tensor_product(sender_feats, sh, node_ell, self._table, weights)
        agg = {l: segment.segment_sum(m, batch.receivers, batch.num_nodes, index=recv_idx)
               / self.avg_nbr for l, m in msgs.items()}
        agg = self.linear_post(agg)

        sc = {l: f * elem_gate[:, None, :] for l, f in self.skip_tp(feats).items()}

        prod: dict = {}
        b = agg
        for nu in range(1, self.correlation + 1):
            if nu > 1:
                wts = {p: getattr(self, f"prod_w{nu}_{p[0]}{p[1]}{p[2]}")
                       for p in self.prod_paths}
                b = tensor_product(b, agg, node_ell, self._table, wts)
            for l, t in getattr(self, f"prod_linear_{nu}")(b).items():
                if l <= node_ell:
                    term = t * elem_gate[:, None, :]
                    prod[l] = prod[l] + term if l in prod else term

        # the first layer's skip has scalars only
        out = {l: prod[l] + sc[l] if l in sc else prod[l] for l in prod}
        # blocks this layer cannot reach are zero, so the packed layout stays
        # the same across layers
        for l in range(self.out_ell + 1):
            if l not in out:
                out[l] = out[0].new_zeros((batch.num_nodes, 2 * l + 1, c))
        out = self.sizing(out)
        inv_out = out[0][:, 0, :]
        if self.last_layer or self.out_ell == 0:
            return inv_out, batch.pos
        return inv_out, _pack_equiv(out, self.out_ell)


__all__ = ["IrrepsLinear", "MACEConv"]
