"""Edge-sharded training of full models: one giant graph per step, its
edges split over the ranks of a process group.

Counterpart of ``hydragnn_tpu/parallel/large_graph.py``. Every rank holds
every node (features, targets, masks: the node and graph fields are
replicated) and a contiguous E/D block of the edge fields (``_EDGE_FIELDS``,
padded to a multiple of D with masked edges wired to the padding node).
XLA partitions any conv stack from the shardings alone; the port places the
collectives by hand, so it supports the stacks whose only edge reduction is
the neighbour sum (GIN, and GPS around GIN):

* each layer's neighbour sum runs B1 on the rank's edge shard and ends with
  one all-reduce of the ``[N, F]`` accumulator (``models/common.py``'s
  ``edge_sharded``): the port of the JAX package's
  ``edge_sharding.sharded_segment_sum`` and ``edge_sharded_conv_step``;
* its input enters the shard through :func:`~.comm.enter_replicated`, so
  the node features' gradient, and with it every parameter's, is whole and
  identical on every rank without a gradient all-reduce;
* GPS ``ring`` attention splits the (replicated) node rows over the same
  ranks (``parallel/ring_attention.py``).

The JAX package turns its Pallas scatter off on this path because SPMD
cannot split a ``pallas_call``. The port has no such reason: each rank's
partial sums go through B1 and B2 on its own shard, an ordinary launch.

``edge_sharding: "full"`` (node fields sharded at rest too) is not ported.
Neither the steps here nor the halo route are captured as CUDA graphs:
they run eager, one giant batch per step, as the JAX package pins them to
one step per dispatch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graphs.batching import batch_from_arrays, batch_meta
from ..graphs.graph import FIELDS, GraphBatch
from ..models.common import edge_sharded
from .comm import rank_of, world_of

# GraphBatch fields whose leading axis is the edge (or triplet) dimension
_EDGE_FIELDS = frozenset({"senders", "receivers", "edge_attr", "edge_shifts", "edge_mask",
                          "idx_kj", "idx_ji", "triplet_mask", "rel_pe"})

# stacks whose every edge reduction is ``common.neighbour_sum``
EDGE_SHARDED_CONVS = frozenset({"GIN"})


def validate_edge_sharding(spec, training: dict | None = None) -> None:
    """Refuse what the edge-sharded route does not run."""
    if spec.sync_batch_norm:
        raise ValueError(
            "SyncBatchNorm is not supported with edge_sharding: the graph is ONE giant sample "
            "split across ranks; feature norms already see the full node set")
    if spec.mpnn_type not in EDGE_SHARDED_CONVS:
        raise NotImplementedError(
            f"edge_sharding runs {sorted(EDGE_SHARDED_CONVS)} (and GPS around them) in the port; "
            f"{spec.mpnn_type}'s other edge reductions are not sharded yet (a later slice: "
            "parallelism)")
    if spec.enable_interatomic_potential:
        raise NotImplementedError("edge_sharding with the interatomic-potential loss is not "
                                  "ported (a later slice: parallelism)")
    if spec.conv_checkpointing:
        raise NotImplementedError("edge_sharding with conv_checkpointing is not ported (a "
                                  "later slice: parallelism)")


def bind_ring(model, group=None) -> None:
    """Hand GPS ring attention the ranks its row blocks live on."""
    from ..models.gps import GraphMultiheadAttention

    for m in model.modules():
        if isinstance(m, GraphMultiheadAttention):
            m.ring_group = group


def put_large_batch(batch, group=None, device=None) -> GraphBatch:
    """This rank's share of one collated batch over ``group``'s ranks
    (:func:`edge_share`), on ``device``."""
    return edge_share(batch, world_of(group), rank_of(group), device)


def edge_share(batch, world: int, rank: int, device=None) -> GraphBatch:
    """Rank ``rank`` of ``world``'s share of one collated batch: every node
    and graph field, and its contiguous block of the edge fields after
    padding the edge count to a multiple of ``world`` with masked edges
    wired to the padding node ``N - 1``; on ``device``."""
    arr = {f: (getattr(batch, f).detach().cpu().numpy() if torch.is_tensor(getattr(batch, f))
               else np.asarray(getattr(batch, f))) for f in FIELDS}
    if arr["idx_kj"].shape[0]:
        raise NotImplementedError("edge_sharding of triplet (DimeNet) batches is not ported")
    n_node = arr["x"].shape[0]
    out = {}
    for f in FIELDS:
        a = arr[f]
        if f in _EDGE_FIELDS and a.shape[0]:
            pad = -a.shape[0] % world
            if pad:
                fill = n_node - 1 if f in ("senders", "receivers") else 0
                a = np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1), constant_values=fill)
            per = a.shape[0] // world
            a = a[rank * per:(rank + 1) * per]
        out[f] = np.ascontiguousarray(a)
    meta = batch_meta(out)
    if batch.meta is not None and batch.meta.max_n_node is not None:
        meta = type(meta)(**{**meta.__dict__, "max_n_node": batch.meta.max_n_node})
    local = batch_from_arrays(out, meta)
    return local if device is None else local.to(device)


def make_edge_sharded_apply(model, compute_dtype: torch.dtype = torch.float32, group=None):
    """``batch -> per-head outputs`` (replicated) over this rank's share of
    an edge-sharded batch."""
    from ..train.step import make_predict_step

    validate_edge_sharding(model.spec)
    bind_ring(model, group)
    predict = make_predict_step(model, compute_dtype)

    def apply(batch):
        with edge_sharded(group):
            return predict(batch)

    return apply


def make_edge_sharded_train_step(model, compute_dtype: torch.dtype = torch.float32,
                                 group=None, loss_scale: float | None = None):
    """``(state, share) -> metrics``: the train step over this rank's edge
    share; the loss and every gradient come out whole and identical on
    every rank, so the optimizer steps as on one device."""
    from ..train.step import make_train_loss, optimizer_step

    validate_edge_sharding(model.spec)
    bind_ring(model, group)
    loss = make_train_loss(compute_dtype)

    def step(state, batch) -> dict:
        with edge_sharded(group):
            tot, tasks = loss(state, batch)
        return optimizer_step(state, batch, tot, tasks, loss_scale)

    return step


def make_edge_sharded_eval_step(model, compute_dtype: torch.dtype = torch.float32, group=None):
    """``(state, share) -> metrics`` with ``make_eval_step``'s keys."""
    from ..train.step import make_eval_step

    validate_edge_sharding(model.spec)
    bind_ring(model, group)
    inner = make_eval_step(compute_dtype)

    def eval_step(state, batch) -> dict:
        with edge_sharded(group):
            return inner(state, batch)

    return eval_step


__all__ = ["EDGE_SHARDED_CONVS", "bind_ring", "edge_share", "make_edge_sharded_apply",
           "make_edge_sharded_eval_step", "make_edge_sharded_train_step", "put_large_batch",
           "validate_edge_sharding"]
