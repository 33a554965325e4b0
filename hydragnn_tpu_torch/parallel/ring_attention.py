"""Ring attention over the node rows of a process group: GPS global
attention on a giant graph (``global_attn_type: "ring"``).

Counterpart of ``hydragnn_tpu/parallel/ring_attention.py``. Each rank of
the group holds one block of ``N / D`` query rows; the key, value, graph-id
and mask blocks rotate ``D - 1`` hops around the ring (rank ``r`` sends to
``r + 1``), and each hop folds its block into an online softmax (running
max, denominator and weighted sum, the flash-attention recurrence), masked
to keys of the same graph that are real nodes. No rank ever holds an
``[N, N]`` logit matrix, and the result is exact: the masked softmax
attention within each graph.

Point-to-point sends carry no autograd, so the ring is one
``torch.autograd.Function`` whose backward is a second ring pass: each
rank keeps the row statistics of its forward (max, denominator, output),
and the key and value blocks travel the ring again with their gradient
accumulators, each rank adding its query rows' share; after ``D`` hops the
accumulators are back with the block's owner. This keeps the memory of the
forward, ``O(N / D)`` rows per rank, where all-gathering the keys and
values (with a reduce-scatter backward) would hold all ``N`` on every rank.

The inputs are the replicated ``[N, H, Dh]`` projections of the
edge-sharded route, where every rank holds every node: each rank takes its
row block through :func:`~.comm.enter_replicated` (the rows' gradients are
summed over the ranks backward, so the projections' gradients are whole on
every rank) and the output blocks are all-gathered
(:func:`~.comm.gather_rows`). Without a group, or on a world of one, the
ring has one block. The JAX package has no Pallas kernel here (its ring is
XLA's), and neither does the port: the hops are ``einsum``s and the
rotation NCCL (gloo on the CPU) ``batch_isend_irecv``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .comm import enter_replicated, gather_rows, rank_of, world_of

_NEG = -1e9


def _global_rank(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _rotate(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor sent to the next rank of the ring and replaced by the
    previous rank's."""
    world, rank = world_of(group), rank_of(group)
    dst = _global_rank(group, (rank + 1) % world)
    src = _global_rank(group, (rank - 1) % world)
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group))
        ops.append(dist.P2POp(dist.irecv, o, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _logits(q, k, bid_q, bid_k, mask_k, scale):
    valid = (bid_q[:, None] == bid_k[None, :]) & (mask_k[None, :] > 0)  # [n, m]
    logits = torch.einsum("nhd,mhd->nhm", q, k) * scale
    return torch.where(valid[:, None, :], logits, torch.full_like(logits, _NEG)), valid


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bid, mask, group):
        world = world_of(group)
        n, heads, dh = q.shape
        scale = 1.0 / math.sqrt(dh)
        mx = torch.full((n, heads), _NEG, dtype=q.dtype, device=q.device)
        den = torch.zeros((n, heads), dtype=q.dtype, device=q.device)
        acc = torch.zeros_like(q)
        kc, vc, bc, mc = k, v, bid, mask
        for hop in range(world):
            if hop:
                kc, vc, bc, mc = _rotate([kc, vc, bc, mc], group)
            logits, valid = _logits(q, kc, bid, bc, mc, scale)
            new_mx = torch.maximum(mx, logits.amax(dim=-1))
            corr = torch.exp(mx - new_mx)
            p = torch.exp(logits - new_mx[..., None]) * valid[:, None, :].to(q.dtype)
            den = den * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("nhm,mhd->nhd", p, vc)
            mx = new_mx
        den = torch.clamp(den, min=1e-20)
        out = acc / den[..., None]
        ctx.group, ctx.scale = group, scale
        ctx.save_for_backward(q, k, v, bid, mask, out, mx, den)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bid, mask, out, mx, den = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        world = world_of(group)
        g = g.contiguous()
        delta = (g * out).sum(dim=-1)  # [n, H]
        dq = torch.zeros_like(q)
        kc, vc, bc, mc = k, v, bid, mask
        dkc, dvc = torch.zeros_like(k), torch.zeros_like(v)
        for hop in range(world):
            if hop:
                kc, vc, bc, mc, dkc, dvc = _rotate([kc, vc, bc, mc, dkc, dvc], group)
            logits, valid = _logits(q, kc, bid, bc, mc, scale)
            p = (torch.exp(logits - mx[..., None]) * valid[:, None, :].to(q.dtype)
                 / den[..., None])
            dvc = dvc + torch.einsum("nhm,nhd->mhd", p, g)
            ds = p * (torch.einsum("nhd,mhd->nhm", g, vc) - delta[..., None])
            dq = dq + torch.einsum("nhm,mhd->nhd", ds, kc) * scale
            dkc = dkc + torch.einsum("nhm,nhd->mhd", ds, q) * scale
        if world > 1:
            # the block held after the last hop is the next rank's: one more
            # hop takes every accumulator home
            dkc, dvc = _rotate([dkc, dvc], group)
        return dq, dkc, dvc, None, None, None


def ring_attention_block(q, k, v, bid, mask, group=None) -> torch.Tensor:
    """This rank's ``[n, H, Dh]`` output block from its own query, key and
    value blocks (``bid`` its rows' graph ids, ``mask`` 1 for real nodes),
    the other ranks' key and value blocks reached around the ring."""
    return _Ring.apply(q, k, v, bid, mask.to(q.dtype), group)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, batch_ids: torch.Tensor,
                   node_mask: torch.Tensor, group=None) -> torch.Tensor:
    """Masked same-graph softmax attention ``[N, H, Dh]`` of replicated
    projections, as a ring over ``group``'s ranks (each its block of ``N /
    D`` rows; the padded node count must divide by ``D``)."""
    world, rank = world_of(group), rank_of(group)
    n_total = q.shape[0]
    if n_total % world:
        raise ValueError(f"global_attn_type 'ring' needs the padded node count ({n_total}) "
                         f"divisible by the ring's ranks ({world}); pad the bucket's n_node "
                         f"to a multiple of {world}")
    n = n_total // world
    rows = slice(rank * n, (rank + 1) * n)
    qkv = enter_replicated(torch.stack([q, k, v]), group)[:, rows]
    out = ring_attention_block(qkv[0], qkv[1], qkv[2], batch_ids[rows], node_mask[rows], group)
    return gather_rows(out, group)


__all__ = ["ring_attention", "ring_attention_block"]
