"""GATv2 conv layer (PyG ``GATv2Conv``, heads = 6, self loops added).

Counterpart of ``hydragnn_tpu/models/gat.py``. Layers 0 .. L-2 concatenate
their 6 heads (``6 * hidden`` features), the last layer averages them. The
attention logit of edge ``j -> i`` is ``att . LeakyReLU_0.05(W_l x_j +
W_r x_i)``, normalised over each receiver's in-edges and its self loop.

The edges are the batch's extended layout (``GraphBatch.self_loop_edges``,
built once per batch): the real edges, ``self_loop_pad(E)`` masked slots
wired to the dummy node N-1, then one self loop per node, exactly the JAX
model's arrays. Masked slots get the logit -1e9 and weight 0. The softmax
is the segment-softmax kernel and the aggregation of the ``[E', 6, F]``
messages the segment-sum kernel, both over the extended receivers' CSR view
(``GraphBatch.csr("loop_receivers")``), which the four layers, the softmax's
backward and the aggregation share. The node features are gathered onto the
entries with ``gather_rows``, whose backward is the segment-sum kernel over
the senders' and receivers' views: no atomics, so training on the card is
reproducible.

With edge features (``edge_dim > 0``) the logit's argument gains
``lin_edge(e_ij)`` (``in -> 6 * hidden``, with bias). A self loop's edge
feature is the mean of its node's incoming real edges' (PyG's
``fill_value='mean'``): the masked features and the edge mask summed by
receiver with the segment-sum kernel (two launches a layer, as the JAX
model recomputes them per layer), divided by the degree clamped at 1; the
``self_loop_pad`` slots get zeros.

Under edge sharding (``models/common.py``'s edge-space helpers) each rank
holds its block of the edges and its block of the layout's tail (the
alignment slots of the whole batch's edge count and the self loops, cut
into one block per rank: ``graphs/graph.py::loop_tail``). The softmax is
B3's split form (each rank's per-receiver statistics, combined over the
ranks, then the normalisation), the aggregation and the self loops' mean
edge feature are summed over the ranks, and the attention dropout's mask is
drawn over the whole layout, so every rank keeps the one-device step's
mask rows. At one rank the layout, the softmax's bits and the mask are the
one-device step's.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..graphs.graph import GraphBatch, loop_tail, loop_tail_mask
from .common import (Dense, Dropout, edge_dropout, edge_gather, edge_operand,
                     edge_segment_softmax, edge_segment_sum, edge_shard, enter_edges,
                     lecun_normal_, member_exact)

HEADS = 6  # the reference GAT stack hard-codes 6 attention heads
NEGATIVE_SLOPE = 0.05
MASK_FILL = -1e9


class GATConv(nn.Module):
    """Parameters ``lin_l``, ``lin_r`` (``in -> 6 * hidden``), ``att``
    ``[6, hidden]`` (flax's lecun-normal over its first axis) and, with edge
    features, ``lin_edge`` (``edge_dim -> 6 * hidden``)."""


    def __init__(self, spec: ModelSpec, layer: int, in_features: int,
                 out_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = out_dim or spec.hidden_dim
        self.concat = layer < spec.num_conv_layers - 1
        width = HEADS * self.hidden
        self.lin_l = Dense(in_features, width, generator)
        self.lin_r = Dense(in_features, width, generator)
        self.att = nn.Parameter(torch.empty(HEADS, self.hidden))
        lecun_normal_(self.att, generator, fan_in=HEADS)
        self.lin_edge = Dense(spec.edge_dim, width, generator) if spec.edge_dim else None
        self.attn_drop = Dropout(spec.dropout)

    @staticmethod
    def out_features(spec: ModelSpec, layer: int) -> int:
        concat = layer < spec.num_conv_layers - 1
        return HEADS * spec.hidden_dim if concat else spec.hidden_dim

    def forward(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                train: bool = False, generator: torch.Generator | None = None):
        n, f = batch.num_nodes, self.hidden
        x_l = self.lin_l(inv).reshape(n, HEADS, f)
        x_r = self.lin_r(inv).reshape(n, HEADS, f)
        # under edge sharding over several ranks, this rank's share of the
        # whole batch's layout: its edges and its block of the tail
        shard = edge_shard() or (1, 0)
        split = shard[0] > 1
        senders, receivers = batch.self_loop_edges(shard)
        mask = batch.edge_mask
        e_mask = torch.cat([mask, loop_tail_mask(batch.num_edges, n, *shard,
                                                 device=mask.device).to(mask.dtype)])
        on_card = inv.is_cuda
        index = batch.csr("loop_receivers", shard) if on_card else None
        # the senders' view serves only the gradient of the gather
        send_index = (batch.csr("loop_senders", shard)
                      if on_card and torch.is_grad_enabled() and x_l.requires_grad else None)

        # gather_rows, not x_l[senders]: autograd's backward of advanced
        # indexing is an index_put_ that CUDA runs as a sort walking
        # duplicate ids one by one, and the dummy node N-1 sends ~11.5k
        # entries at the top QM9 bucket (a bf16 train step's backward took
        # 93.6 ms on an H100)
        x_ls = edge_gather(x_l, senders, send_index)
        z = x_ls + edge_gather(x_r, receivers, index)
        if self.lin_edge is not None:
            z = z + self.lin_edge(self._loop_edge_attr(batch, shard)).reshape(-1, HEADS, f)
        # jax.nn.leaky_relu: where(z >= 0, z, slope * z), whose gradient at
        # z = 0 is 1 (F.leaky_relu's is the slope; z is exactly 0 on every
        # edge between zero-feature nodes while the biases are 0)
        z = torch.where(z >= 0, z, NEGATIVE_SLOPE * z)
        dtype = torch.promote_types(z.dtype, self.att.dtype)  # as jnp.einsum promotes
        logits = member_exact(functools.partial(torch.einsum, "ehf,hf->eh"), z.to(dtype),
                              edge_operand(self.att, z).to(dtype))
        logits = torch.where(e_mask[:, None] > 0, logits, MASK_FILL)
        alpha = edge_segment_softmax(logits, receivers, n, index=index)
        alpha = alpha * e_mask[:, None]
        total, rows = (self._global_rows(batch, shard, alpha.device)
                       if split and train and self.attn_drop.rate > 0 else (None, None))
        alpha = edge_dropout(self.attn_drop, alpha, train, generator, total, rows)

        msg = x_ls * alpha[:, :, None]
        out = edge_segment_sum(msg, receivers, n, index=index)  # [N, heads, F]
        out = out.reshape(n, HEADS * f) if self.concat else out.mean(dim=1)
        return out, equiv

    @staticmethod
    def _global_rows(batch: GraphBatch, shard, device) -> tuple[int, torch.Tensor]:
        """The whole batch's layout's row count, and each row of this rank's
        share in it (its edges' block, then its tail block; -1 past the
        tail): the attention dropout's mask is drawn over the whole
        layout."""
        world, rank = shard
        e, n = batch.num_edges, batch.num_nodes
        slots, start, rows = loop_tail(e, n, world, rank)
        t = torch.arange(start, start + rows, device=device)
        tail = torch.where(t < slots + n, world * e + t, torch.full_like(t, -1))
        return (world * e + slots + n,
                torch.cat([torch.arange(rank * e, (rank + 1) * e, device=device), tail]))

    @staticmethod
    def _loop_edge_attr(batch: GraphBatch, shard) -> torch.Tensor:
        """The extended layout's edge features: the real edges', zeros on
        the alignment slots, and each node's mean incoming real edge feature
        on its self loop (under edge sharding, the means over every rank's
        edges, on this rank's share of the layout)."""
        n, ea, mask = batch.num_nodes, batch.edge_attr, batch.edge_mask
        index = batch.csr("receivers") if ea.is_cuda else None
        ea_sum = edge_segment_sum(ea * mask[:, None], batch.receivers, n, index=index)
        deg = edge_segment_sum(mask[:, None], batch.receivers, n, index=index)
        self_ea = ea_sum / torch.clamp(deg, min=1.0)
        # this rank's tail block: its self loops are a contiguous run of
        # nodes between alignment or padding slots (one rank: the slots,
        # then every node)
        slots, start, rows = loop_tail(batch.num_edges, n, *shard)
        a = min(max(slots - start, 0), rows)
        b = min(max(slots + n - start, 0), rows)
        lo = start + a - slots
        loops = enter_edges(self_ea)[lo:lo + b - a]
        return torch.cat([ea, ea.new_zeros((a, ea.shape[1])), loops,
                          ea.new_zeros((rows - b, ea.shape[1]))])


__all__ = ["GATConv", "HEADS", "NEGATIVE_SLOPE"]
