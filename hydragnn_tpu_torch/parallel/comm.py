"""The collectives of the parallel layouts, with the gradients XLA gives
their counterparts in the JAX package.

Every function takes a ``torch.distributed`` process group (``None``: the
default group) and is the identity when no group has been formed, so a
single process runs the same code as one rank. A formed group of one rank
still runs its collectives (each the identity on the values), so a
one-card run goes through the same NCCL calls as four.
Each one is NCCL on the card and gloo on the CPU; none is a kernel.

* :func:`all_reduce_sum` is ``lax.psum`` under ``vmap``/``shard_map``:
  the sum over ranks forward, the sum of the cotangents backward (SyncBN's
  moments, the halo route's loss and pooled readouts);
* :func:`enter_replicated` and :func:`exit_sum` are the pair that bounds a
  rank-local region inside a replicated computation (the edge-sharded
  route's edge shards, ring attention's row blocks): the entry is the
  identity forward and sums the rank-local cotangents backward, so the
  replicated tensor's gradient is whole on every rank; the exit sums the
  partial results forward and passes the (replicated) cotangent through;
* :func:`gather_rows` all-gathers equal row blocks and hands each rank its
  block of the (replicated) cotangent back; behind an
  :func:`enter_replicated` (DimeNet's triplets read edge rows of every
  rank), the cotangent is summed over the ranks first;
* :func:`all_reduce_extreme` is the max or min over the ranks, its
  cotangent split among the ranks that hold the extreme as one device
  splits it among tied entries; :func:`reduce_tensor` a reduction without
  autograd (the split segment softmax's statistics);
* :func:`enter_replicated` and :func:`gather_columns` are also Megatron's
  f/g pair around a column-parallel dense layer (the tensor-parallel route,
  ``parallel/tensor.py``): f, the identity forward and the all-reduce of
  the partial input gradients backward; g, the all-gather of the ranks'
  column blocks forward and this rank's block of the cotangent backward;
* :func:`send_recv` exchanges tensors with pipeline neighbours
  (``batch_isend_irecv``; ``parallel/pipeline.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def live() -> bool:
    """Whether a process group has been formed."""
    return dist.is_available() and dist.is_initialized()


def world_of(group=None) -> int:
    """The group's size; 1 when no group has been formed."""
    return dist.get_world_size(group) if live() else 1


def rank_of(group=None) -> int:
    """This process's rank in the group; 0 when no group has been formed."""
    return dist.get_rank(group) if live() else 0


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _EnterReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ExitSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        world = dist.get_world_size(group)
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        world = dist.get_world_size(group)
        ctx.rank, ctx.cols = dist.get_rank(group), x.shape[-1]
        parts = x.movedim(-1, 0).contiguous()
        out = parts.new_empty((world * parts.shape[0],) + tuple(parts.shape[1:]))
        dist.all_gather_into_tensor(out, parts, group=group)
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.cols, ctx.cols).contiguous(), None


class _AllReduceExtreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op, ties):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=op, group=group)
        ctx.group = group
        ctx.save_for_backward(x, out, ties)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, ties = ctx.saved_tensors
        # each rank's share of the cotangent: its tied entries over every
        # rank's (one device splits an extreme's gradient evenly among its
        # tied entries); the total clamped at 1 where no rank holds it
        # (non-finite entries), where the share is 0 too
        share = torch.where(x == out, ties.to(g.dtype), torch.zeros_like(g))
        total = torch.clamp(_sum(share, ctx.group), min=1.0)
        return g * (share / total), None, None, None


def reduce_tensor(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """A new tensor holding ``x`` reduced over the group's ranks (``op``
    "sum" or "max"), without autograd; ``x`` when no group has been
    formed."""
    if not live():
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group's ranks; backward, the sum of the cotangents."""
    return _AllReduceSum.apply(x, group) if live() else x


def all_reduce_extreme(x: torch.Tensor, group=None, kind: str = "max",
                       ties: torch.Tensor | None = None) -> torch.Tensor:
    """Element-wise max (``kind="max"``) or min over the ranks. The
    cotangent goes to the ranks that hold the extreme, split among them in
    proportion to ``ties`` (same shape as ``x``: how many of this rank's
    entries each local extreme stands for, as a segment's max counts its
    tied entries), so a cross-rank tie splits the gradient as one device
    splits it among tied entries; without ``ties`` each holding rank counts
    once."""
    if not live():
        return x
    op = dist.ReduceOp.MAX if kind == "max" else dist.ReduceOp.MIN
    return _AllReduceExtreme.apply(x, group, op, torch.ones_like(x) if ties is None else ties)


def enter_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity; backward, the sum of the ranks' cotangents."""
    return _EnterReplicated.apply(x, group) if live() else x


def exit_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of the ranks' partial results; backward, the identity."""
    return _ExitSum.apply(x, group) if live() else x


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' equal row blocks concatenated in rank order; backward,
    this rank's block of the cotangent."""
    return _GatherRows.apply(x, group) if live() else x


def gather_columns(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' equal column blocks (last axis) concatenated in rank
    order; backward, this rank's block of the (replicated) cotangent."""
    return _GatherColumns.apply(x, group) if live() else x


def send_recv(sends: list, recvs: list, group=None) -> None:
    """Post every ``(tensor, peer)`` of ``sends`` and ``recvs`` (peers are
    ranks of the default group) as one ``batch_isend_irecv`` and wait for
    them all; the received tensors are filled in place."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer, group) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def sum_tensors(tensors: list[torch.Tensor], group=None) -> None:
    """Sum every tensor of ``tensors`` over the group in place, as one
    collective over their concatenation (no autograd)."""
    if not live() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


__all__ = ["all_reduce_extreme", "all_reduce_sum", "enter_replicated", "exit_sum",
           "gather_columns", "gather_rows", "live", "rank_of", "reduce_tensor", "send_recv",
           "sum_tensors", "world_of"]
