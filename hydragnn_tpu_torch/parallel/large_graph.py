"""Edge-sharded training of full models: one giant graph per step, its
edges split over the ranks of a process group.

Counterpart of ``hydragnn_tpu/parallel/large_graph.py``. Every rank holds
every node (features, targets, masks: the node and graph fields are
replicated) and a contiguous E/D block of the edge fields (``_EDGE_FIELDS``,
padded to a multiple of D with masked edges wired to the padding node);
DimeNet's triplets go to the rank that holds their ``idx_ji`` edge
(:func:`edge_share`). XLA partitions any conv stack from the shardings
alone; the port places the collectives by hand, at one boundary, the
edge-space helpers of ``models/common.py``, which every one of the thirteen
stacks calls:

* a node tensor read on edges enters through
  :func:`~.comm.enter_replicated`, so its gradient is whole and identical
  on every rank without a gradient all-reduce; a parameter read on edge
  rows enters the same way at each use (a ``Dense`` applied to a tensor of
  the share's edge rows, ``models/common.py::edge_operand``: the share's
  edge and triplet counts are chosen apart from its node and graph counts,
  :func:`edge_share`);
* every edge -> node sum (B1 and B2 on the rank's shard), count and mean
  ends with one all-reduce of its numerator and count before any division
  (the port of ``edge_sharding.sharded_segment_sum``); PNA's extremes are
  reduced over the ranks before their non-finite results become 0; GAT's
  softmax runs B3 in split form (statistics, their combine, normalise);
  DimeNet's triplets all-gather the edge messages they read;
* GPS ``ring`` attention splits the (replicated) node rows over the same
  ranks (``parallel/ring_attention.py``); GPS multihead attention, norms,
  pooling and heads are node-level and replicated;
* a checkpointed conv (``conv_checkpointing``) recomputes in the group of
  its first pass (``models/common.py::checkpointed``).

The JAX package turns its Pallas scatter off on this path because SPMD
cannot split a ``pallas_call``. The port has no such reason: each rank's
partial sums go through B1 and B2 on its own shard, an ordinary launch.

Refused: SyncBatchNorm (the JAX package's reason), the interatomic
potential's force loss (the JAX package's edge-sharded step calls
``model.loss``, which has no force term: it would train a potential
without its forces, so the port does not add that route) and
``edge_sharding: "full"`` (node fields sharded at rest: the next
parallelism slice). Neither the steps here nor the halo route are captured
as CUDA graphs: they run eager, one giant batch per step, as the JAX
package pins them to one step per dispatch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graphs.batching import batch_from_arrays, batch_meta
from ..graphs.graph import FIELDS, GraphBatch
from ..graphs.graph import edge_space_rows
from ..models.common import edge_sharded
from .comm import rank_of, world_of

# GraphBatch fields whose leading axis is the edge (or triplet) dimension
_EDGE_FIELDS = frozenset({"senders", "receivers", "edge_attr", "edge_shifts", "edge_mask",
                          "idx_kj", "idx_ji", "triplet_mask", "rel_pe"})
# of those, DimeNet's triplets, which go to the rank of their idx_ji edge
_TRIPLET_FIELDS = ("idx_kj", "idx_ji", "triplet_mask")

# every stack of the port: each reduces over edges through the edge-space
# helpers of ``models/common.py``
EDGE_SHARDED_CONVS = frozenset({"GIN", "SAGE", "MFC", "GAT", "PNA", "PNAPlus", "CGCNN",
                                "SchNet", "EGNN", "PAINN", "PNAEq", "MACE", "DimeNet"})


def validate_edge_sharding(spec, training: dict | None = None) -> None:
    """Refuse what the edge-sharded route does not run."""
    if spec.sync_batch_norm:
        raise ValueError(
            "SyncBatchNorm is not supported with edge_sharding: the graph is ONE giant sample "
            "split across ranks; feature norms already see the full node set")
    if spec.mpnn_type not in EDGE_SHARDED_CONVS:
        raise NotImplementedError(
            f"edge_sharding runs {sorted(EDGE_SHARDED_CONVS)} in the port, not "
            f"{spec.mpnn_type}")
    if spec.enable_interatomic_potential:
        raise NotImplementedError(
            "edge_sharding with the interatomic-potential loss is not ported: the JAX "
            "package's edge-sharded step computes model.loss, which has no force term, so it "
            "would train the potential without its forces; the port adds no such route")


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
    wired to the padding node ``N - 1``; on ``device``. The padding grows
    by ``world`` edges at a time while a count of the share's edge-space
    rows (``graphs/graph.py::edge_space_rows``) equals its node or graph
    count, so that the rows a layer is applied to tell edges from nodes
    (``models/common.py::edge_operand``).

    DimeNet's triplets: the rank keeps those whose ``idx_ji`` edge is in
    its block, in their order, ``idx_ji`` renumbered into the block and
    ``idx_kj`` left global (the triplet sum all-gathers the edge messages
    it reads, ``models/dimenet.py``). Every rank's triplet count is padded
    to the largest (at least 1, and apart from the node and graph counts)
    with masked triplets on its last edge slot, reading the last edge slot
    of the whole batch."""
    arr = {f: (getattr(batch, f).detach().cpu().numpy() if torch.is_tensor(getattr(batch, f))
               else np.asarray(getattr(batch, f))) for f in FIELDS}
    n_node = arr["x"].shape[0]
    node_rows = {n_node, arr["graph_mask"].shape[0]}
    per = -(-arr["senders"].shape[0] // world)
    while edge_space_rows(per, n_node, 0, world, rank) & node_rows:
        per += 1
    out = {}
    for f in FIELDS:
        a = arr[f]
        if f in _EDGE_FIELDS and f not in _TRIPLET_FIELDS and a.shape[0]:
            pad = per * world - a.shape[0]
            if pad:
                fill = n_node - 1 if f in ("senders", "receivers") else 0
                a = np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1), constant_values=fill)
            a = a[rank * per:(rank + 1) * per]
        out[f] = np.ascontiguousarray(a)
    if arr["idx_kj"].shape[0]:
        out.update(_triplet_share(arr, per, world, rank, node_rows))
    meta = batch_meta(out)
    if batch.meta is not None and batch.meta.max_n_node is not None:
        meta = type(meta)(**{**meta.__dict__, "max_n_node": batch.meta.max_n_node})
    local = batch_from_arrays(out, meta)
    return local if device is None else local.to(device)


def _triplet_share(arr: dict, per: int, world: int, rank: int, node_rows: set) -> dict:
    """The triplet fields of rank ``rank``'s share (:func:`edge_share`) of
    ``per`` edges a rank."""
    ji = arr["idx_ji"].astype(np.int64)
    owner = ji // per
    t_max = max(int(np.bincount(owner, minlength=world).max()), 1)
    while t_max in node_rows:
        t_max += 1
    mine = np.nonzero(owner == rank)[0]
    pad = t_max - mine.shape[0]
    kj = np.concatenate([arr["idx_kj"][mine], np.full(pad, world * per - 1)])
    local_ji = np.concatenate([ji[mine] - rank * per, np.full(pad, per - 1)])
    mask = np.concatenate([arr["triplet_mask"][mine], np.zeros(pad)])
    return {"idx_kj": kj.astype(arr["idx_kj"].dtype),
            "idx_ji": local_ji.astype(arr["idx_ji"].dtype),
            "triplet_mask": mask.astype(arr["triplet_mask"].dtype)}


def make_edge_sharded_apply(model, compute_dtype: torch.dtype = torch.float32, group=None):
    """``batch -> per-head outputs`` (replicated) over this rank's share of
    an edge-sharded batch."""
    from ..train.step import make_predict_step

    validate_edge_sharding(model.spec)
    bind_ring(model, group)
    predict = make_predict_step(model, compute_dtype)

    def apply(batch):
        with edge_sharded(group, batch):
            return predict(batch)

    return apply


def make_edge_sharded_train_step(model, compute_dtype: torch.dtype = torch.float32,
                                 group=None, loss_scale: float | None = None):
    """``(state, share) -> metrics``: the train step over this rank's edge
    share; the loss and every gradient come out whole and identical on
    every rank, so the optimizer steps as on one device."""
    from ..train.step import cast_forward, optimizer_step

    validate_edge_sharding(model.spec)
    bind_ring(model, group)

    def step(state, batch) -> dict:
        m = state.model
        with edge_sharded(group, batch):
            pred = cast_forward(m, batch, compute_dtype, train=True, generator=state.generator)
            tot, tasks = m.loss(pred, batch)
        return optimizer_step(state, batch, tot, tasks, loss_scale)

    return step


def make_edge_sharded_eval_step(model, compute_dtype: torch.dtype = torch.float32, group=None):
    """``(state, share) -> metrics`` with ``make_eval_step``'s keys."""
    from ..train.step import make_eval_step

    validate_edge_sharding(model.spec)
    bind_ring(model, group)
    inner = make_eval_step(compute_dtype)

    def eval_step(state, batch) -> dict:
        with edge_sharded(group, batch):
            return inner(state, batch)

    return eval_step


__all__ = ["EDGE_SHARDED_CONVS", "bind_ring", "edge_share", "make_edge_sharded_apply",
           "make_edge_sharded_eval_step", "make_edge_sharded_train_step", "put_large_batch",
           "validate_edge_sharding"]
