"""Halo-exchange message passing: one giant graph, node-resident over the
ranks of a process group.

Counterpart of ``hydragnn_tpu/parallel/halo.py``. The graph is partitioned
spatially (``graphs/partition.py``: cell-list grid, Morton order,
count-balanced ranges) and each rank keeps only

* its owned nodes (features, targets, masks: 1/D of the graph),
* its owned edges (every edge whose receiver it owns, so each rank's
  aggregate of its own nodes is complete), and
* halo slots: copies of the remote senders its owned edges read.

Before every conv layer after the first, only the halo rows are refreshed:
a static ring schedule of ``D - 1`` shifts moves each boundary row from its
owner into the ranks' halo slots (:class:`HaloPlan`, built on the host at
collate time, bucket-padded). The JAX package's ``ppermute`` gets its
reverse exchange from XLA's transpose; the port's refresh is a
``torch.autograd.Function`` whose forward sends each shift's rows with
``batch_isend_irecv`` and whose backward sends the halo slots' cotangents
back to their owners and adds them into the owned rows.

Feature-norm statistics, pooled readouts and the masked losses are summed
over the ranks (``MaskedBatchNorm.sync_group``, :func:`pool_reduce_fn`,
``HydraModel.loss(..., group=)``), so every rank computes the union
graph's values; the gradients are averaged over the ranks, as the JAX step
``pmean``s them. Each rank's local aggregation runs through the same
kernels as a one-device step (B1 and B2, B3 under GAT): the local view is
an ordinary padded batch.

One partition (a world of one) is the route's own single-rank form: the
whole graph in Morton order, no halo (the JAX package asks for two or
more partitions).

Config: ``NeuralNetwork.Architecture.halo`` (single-sourced from
:class:`HaloConfig`); env ``HYDRAGNN_HALO`` overrides its ``enabled`` key.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..graphs.batching import batch_from_arrays, batch_meta
from ..graphs.graph import FIELDS, GraphBatch
from ..graphs.partition import boundary_sets, partition_nodes
from ..graphs.segment import segment_count
from ..models.common import MaskedBatchNorm
from ..utils import flags
from .comm import all_reduce_extreme, all_reduce_sum, live, rank_of, sum_tensors, world_of


# -- config -------------------------------------------------------------------

@dataclasses.dataclass
class HaloConfig:
    """``Architecture.halo`` block, the single source of its defaults.

    ``partitions``      0 = one partition per data rank (a nonzero value
                        must match the data ranks).
    ``slot_multiple``   halo send/recv slot lists are padded up to this
                        multiple per ring shift.
    ``node_multiple`` / ``edge_multiple``
                        per-rank node/edge array buckets.
    ``fallback``        what to do when the model is outside halo support:
                        "error" raises, "data" trains data-parallel instead,
                        with a log line.
    """

    enabled: bool = False
    partitions: int = 0
    slot_multiple: int = 8
    node_multiple: int = 8
    edge_multiple: int = 128
    fallback: str = "error"

    def validate(self) -> "HaloConfig":
        if self.partitions < 0:
            raise ValueError(f"halo.partitions must be >= 0, got {self.partitions}")
        for key in ("slot_multiple", "node_multiple", "edge_multiple"):
            if int(getattr(self, key)) < 1:
                raise ValueError(f"halo.{key} must be >= 1, got {getattr(self, key)}")
        if self.fallback not in ("error", "data"):
            raise ValueError(f"halo.fallback must be 'error' or 'data', got {self.fallback!r}")
        return self


def halo_config_defaults() -> dict:
    return dataclasses.asdict(HaloConfig())


def halo_config(arch_cfg: dict | None) -> HaloConfig:
    """Typed view of ``Architecture.halo`` with defaults back-filled."""
    raw = dict((arch_cfg or {}).get("halo") or {})
    return HaloConfig(**{**halo_config_defaults(), **raw}).validate()


def halo_enabled(arch_cfg: dict | None) -> bool:
    """``HYDRAGNN_HALO`` wins over ``Architecture.halo.enabled``."""
    cfg = (arch_cfg or {}).get("halo") or {}
    return bool(flags.get(flags.HALO, default=bool(cfg.get("enabled", False))))


# -- support surface ----------------------------------------------------------

# receiver-directed stacks: owning every in-edge of an owned node makes the
# local aggregate exact, and halo rows only serve as gather sources
HALO_SUPPORTED_CONVS = frozenset({"GIN", "GAT", "PNA", "PNAPlus", "SAGE", "MFC", "CGCNN",
                                  "SchNet"})


def validate_halo_support(spec) -> None:
    """Refuse what the partitioned step cannot reproduce (the JAX
    package's rules)."""
    if spec.mpnn_type not in HALO_SUPPORTED_CONVS:
        raise ValueError(
            f"halo partitioning does not support mpnn_type={spec.mpnn_type!r} "
            f"(receiver-directed stacks only: {sorted(HALO_SUPPORTED_CONVS)}; "
            "DimeNet triplets and MACE per-layer readouts cross partitions)")
    if spec.equivariance:
        raise ValueError(
            "halo partitioning does not support equivariance: coordinate updates aggregate "
            "by SENDER, and a sender owned elsewhere would drop its contribution")
    if spec.global_attn_engine:
        raise ValueError(
            "halo partitioning does not support global attention "
            f"({spec.global_attn_engine}): it is all-to-all over nodes by construction; use "
            "edge_sharding instead")
    if spec.sync_batch_norm:
        raise ValueError(
            "SyncBatchNorm is not supported with halo partitioning: the graph is ONE giant "
            "sample; feature-norm statistics are already summed over the ranks by the halo "
            "step itself")
    if spec.enable_interatomic_potential:
        raise ValueError(
            "halo partitioning does not support the interatomic-potential loss yet: force "
            "autograd differentiates through positions that live on other ranks")
    for b in spec.node_heads:
        if (b.node_type or "mlp") != "mlp":
            raise ValueError(
                f"halo partitioning supports only 'mlp' node heads, got {b.node_type!r}: "
                "per-position banks index GLOBAL node positions and conv heads need their "
                "own halo refreshes")


# -- static plan --------------------------------------------------------------

class HaloPlan(NamedTuple):
    """Static ring-exchange schedule; entry ``i`` is shift ``i + 1``.

    ``send_idx[i]``  [D, S_i]: per rank, local indices (into the owned
                     region) of the rows it sends to rank ``d + s``; padded
                     with 0 (an owned row whose copy lands in a trash slot).
    ``recv_slot[i]`` [D, S_i]: per rank, local indices (into the halo region)
                     where the rows from rank ``d - s`` land; padded with the
                     trash slot ``N_loc - 1``.
    """

    send_idx: tuple
    recv_slot: tuple


class HaloBatch(NamedTuple):
    """One partitioned frame on the host: ``batch`` maps each
    ``GraphBatch`` field to its ``[D, ...]`` stack (rank d's local view at
    index d); ``node_global`` ([D, N_loc], -1 = pad) and ``n_owned`` ([D])
    serve :func:`gather_node_predictions`."""

    batch: dict
    plan: HaloPlan
    node_global: np.ndarray
    n_owned: np.ndarray


class LocalHalo(NamedTuple):
    """One rank's share of a :class:`HaloBatch`: its local view as a
    ``GraphBatch``, its send and receive index lists per shift (tensors on
    the view's device), and the frame (for reassembly on the host)."""

    batch: GraphBatch
    send: list
    recv: list
    frame: HaloBatch

    @property
    def device(self):
        return self.batch.device

    def to(self, device) -> "LocalHalo":
        return LocalHalo(self.batch.to(device), [t.to(device) for t in self.send],
                         [t.to(device) for t in self.recv], self.frame)


def _round_up(v: int, m: int) -> int:
    return int(-(-int(v) // int(m)) * int(m))


# per-node fields gathered into the local views; the graph fields replicate
_NODE_GATHER = ("x", "pos", "node_y", "forces_y", "pe", "z")
_GRAPH_REPLICATE = ("graph_attr", "graph_y", "energy_y", "graph_mask", "dataset_id")


def _host_arrays(batch) -> dict:
    if isinstance(batch, dict):
        return {f: np.asarray(batch[f]) for f in FIELDS}
    return {f: (getattr(batch, f).detach().cpu().numpy() if torch.is_tensor(getattr(batch, f))
                else np.asarray(getattr(batch, f))) for f in FIELDS}


def partition_graph_batch(batch, n_parts: int, cfg: HaloConfig | None = None,
                          cutoff: float | None = None) -> HaloBatch:
    """Split ONE collated single-graph batch (a ``GraphBatch`` or a dict of
    its fields' arrays) into ``n_parts`` local views and the static exchange
    plan; host-side numpy, deterministic, array for array the JAX
    package's for two or more parts. The dummy padding graph is kept: in
    every local view padded nodes and edges point at slot ``N_loc - 1`` of
    graph ``G - 1``."""
    cfg = cfg or HaloConfig()
    arr = _host_arrays(batch)
    n_real_graphs = int(arr["graph_mask"].sum())
    if n_real_graphs != 1:
        raise ValueError(
            f"halo partitioning expects exactly 1 real graph per batch, got {n_real_graphs} "
            "(set Training.batch_size=1 for the giant-graph regime)")
    if n_parts < 1:
        raise ValueError(f"halo partitioning needs >= 1 partition, got {n_parts}")
    G = arr["graph_y"].shape[0]
    n_real = int(np.round(arr["node_mask"].sum()))
    e_real = int(np.round(arr["edge_mask"].sum()))
    # collate packs real rows first; padding is the tail
    pos = arr["pos"][:n_real]
    senders = arr["senders"][:e_real].astype(np.int64)
    receivers = arr["receivers"][:e_real].astype(np.int64)

    plan = partition_nodes(pos, n_parts, cutoff=cutoff)
    owner = plan.owner
    halos = boundary_sets(senders, receivers, owner, n_parts)

    owned = [plan.part(p) for p in range(n_parts)]
    # halo layout per rank: grouped by source partition ascending, each
    # group ascending by global id (the order the plan's send side uses)
    halo_ids = [
        np.concatenate([halos.get((src, d), np.zeros(0, np.int32))
                        for src in range(n_parts)]).astype(np.int64)
        for d in range(n_parts)
    ]
    n_owned = np.array([len(o) for o in owned], np.int64)
    recv_owner = owner[receivers]
    edge_of = [np.nonzero(recv_owner == d)[0] for d in range(n_parts)]

    n_loc = _round_up(int(max(n_owned[d] + len(halo_ids[d]) for d in range(n_parts))) + 1,
                      cfg.node_multiple)
    e_loc = _round_up(max(int(max(len(e) for e in edge_of)), 1), cfg.edge_multiple)

    # global id -> local slot, per rank (owned region then halo region)
    loc_of = []
    for d in range(n_parts):
        m = np.full(n_real, -1, np.int64)
        m[owned[d]] = np.arange(len(owned[d]))
        m[halo_ids[d]] = n_owned[d] + np.arange(len(halo_ids[d]))
        loc_of.append(m)

    fields = {name: [] for name in FIELDS}
    node_global = np.full((n_parts, n_loc), -1, np.int32)
    for d in range(n_parts):
        gids = np.concatenate([owned[d], halo_ids[d]])
        n_here = len(gids)
        node_global[d, :n_here] = gids
        for name in _NODE_GATHER:
            src = arr[name]
            out = np.zeros((n_loc,) + src.shape[1:], src.dtype)
            out[:n_here] = src[gids]
            fields[name].append(out)
        batch_ids = np.full(n_loc, G - 1, arr["batch"].dtype)
        batch_ids[: n_owned[d]] = 0  # halo and pad rows sit in the dummy graph
        fields["batch"].append(batch_ids)
        node_mask = np.zeros(n_loc, arr["node_mask"].dtype)
        node_mask[: n_owned[d]] = 1.0
        fields["node_mask"].append(node_mask)

        eids = edge_of[d]
        snd = np.full(e_loc, n_loc - 1, arr["senders"].dtype)
        rcv = np.full(e_loc, n_loc - 1, arr["receivers"].dtype)
        snd[: len(eids)] = loc_of[d][senders[eids]]
        rcv[: len(eids)] = loc_of[d][receivers[eids]]
        fields["senders"].append(snd)
        fields["receivers"].append(rcv)
        emask = np.zeros(e_loc, arr["edge_mask"].dtype)
        emask[: len(eids)] = 1.0
        fields["edge_mask"].append(emask)
        for name in ("edge_attr", "edge_shifts", "rel_pe"):
            src = arr[name]
            out = np.zeros((e_loc,) + src.shape[1:], src.dtype)
            out[: len(eids)] = src[eids]
            fields[name].append(out)
        nn = np.zeros(G, arr["n_node"].dtype)
        nn[0] = n_owned[d]
        fields["n_node"].append(nn)
        for name in _GRAPH_REPLICATE:
            fields[name].append(arr[name])
        # triplets cross partitions (DimeNet is refused): empty arrays
        for name in ("idx_kj", "idx_ji"):
            fields[name].append(np.zeros(0, arr[name].dtype))
        fields["triplet_mask"].append(np.zeros(0, arr["triplet_mask"].dtype))

    stacked = {name: np.stack(fields[name]) for name in FIELDS}

    send_steps, recv_steps = [], []
    for shift in range(1, n_parts):
        widths = [len(halos.get((d, (d + shift) % n_parts), ())) for d in range(n_parts)]
        s_w = _round_up(max(widths), cfg.slot_multiple) if max(widths) else 0
        send = np.zeros((n_parts, s_w), np.int32)
        recv = np.full((n_parts, s_w), n_loc - 1, np.int32)
        for d in range(n_parts):
            dst = (d + shift) % n_parts
            ids = halos.get((d, dst))
            if ids is not None:
                send[d, : len(ids)] = loc_of[d][ids]  # owned rows on d
                recv[dst, : len(ids)] = loc_of[dst][ids]  # halo slots on dst
        send_steps.append(send)
        recv_steps.append(recv)

    return HaloBatch(batch=stacked,
                     plan=HaloPlan(send_idx=tuple(send_steps), recv_slot=tuple(recv_steps)),
                     node_global=node_global, n_owned=n_owned.astype(np.int32))


def local_view(hbatch: HaloBatch, rank: int, device=None) -> LocalHalo:
    """Rank ``rank``'s view of a frame, on ``device`` (the host without
    one)."""
    arrays = {f: np.ascontiguousarray(hbatch.batch[f][rank]) for f in FIELDS}
    batch = batch_from_arrays(arrays, batch_meta(arrays))
    send = [torch.from_numpy(np.ascontiguousarray(s[rank]).astype(np.int64))
            for s in hbatch.plan.send_idx]
    recv = [torch.from_numpy(np.ascontiguousarray(r[rank]).astype(np.int64))
            for r in hbatch.plan.recv_slot]
    local = LocalHalo(batch, send, recv, hbatch)
    return local if device is None else local.to(device)


def put_halo_batch(batch, group=None, cfg: HaloConfig | None = None,
                   cutoff: float | None = None, device=None) -> LocalHalo:
    """Partition one frame over ``group``'s ranks (every rank computes the
    same plan) and keep this rank's view, on ``device``."""
    cfg = cfg or HaloConfig()
    n_dev = world_of(group)
    if cfg.partitions and cfg.partitions != n_dev:
        raise ValueError(f"halo.partitions={cfg.partitions} != data ranks {n_dev}; set 0 to "
                         "follow the ranks")
    return local_view(partition_graph_batch(batch, n_dev, cfg=cfg, cutoff=cutoff),
                      rank_of(group), device)


# -- analytic comm model ------------------------------------------------------

def halo_boundary_bytes(plan: HaloPlan, feat_dim: int, bytes_per_el: int = 4) -> int:
    """Bytes ONE conv layer's halo refresh moves, summed over the ranks:
    every ring step ships its bucket-padded [S, F] buffer from each rank."""
    rows = sum(int(s.shape[0]) * int(s.shape[1]) for s in plan.send_idx)
    return rows * int(feat_dim) * int(bytes_per_el)


def replicated_allreduce_bytes(n_nodes: int, feat_dim: int, n_dev: int,
                               bytes_per_el: int = 4) -> int:
    """Bytes one ring all-reduce of a replicated [N, F] accumulator moves,
    summed over the ranks: 2 (N F / D) (D - 1) per rank, times D (the
    per-layer cost of the edge-sharded route)."""
    return 2 * (int(n_dev) - 1) * int(n_nodes) * int(feat_dim) * int(bytes_per_el)


# -- the exchange ---------------------------------------------------------------

def _global_rank(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _shift(buf: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send ``buf`` to rank ``dst`` of ``group`` and return the equal-shaped
    buffer rank ``src`` sends."""
    out = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf.contiguous(), _global_rank(group, dst), group),
           dist.P2POp(dist.irecv, out, _global_rank(group, src), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Refresh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, group, sends, recvs):
        world, rank = world_of(group), rank_of(group)
        out = h.clone()
        for i, (snd, rcv) in enumerate(zip(sends, recvs)):
            if snd.numel() == 0:
                continue  # statically empty shift
            shift = i + 1
            got = _shift(out[snd], (rank + shift) % world, (rank - shift) % world, group)
            out[rcv] = got
        ctx.group, ctx.sends, ctx.recvs = group, sends, recvs
        return out

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        world, rank = world_of(group), rank_of(group)
        g = g.clone()
        for i in reversed(range(len(ctx.sends))):
            snd, rcv = ctx.sends[i], ctx.recvs[i]
            if snd.numel() == 0:
                continue
            shift = i + 1
            back = g[rcv]
            g[rcv] = 0  # overwritten slots: the input's rows there got no use
            got = _shift(back, (rank - shift) % world, (rank + shift) % world, group)
            g.index_add_(0, snd, got)
        return g, None, None, None


def make_refresh(sends, recvs, group=None):
    """``layer_hook(inv, equiv)`` refreshing the halo rows of ``inv`` from
    their owners (``equiv`` passes through)."""

    def refresh(inv, equiv):
        if world_of(group) == 1 or not sends:
            return inv, equiv
        return _Refresh.apply(inv, group, list(sends), list(recvs)), equiv

    return refresh


def pool_reduce_fn(kind: str, batch: GraphBatch, group=None):
    """Merge the ranks' partial readouts into the union graph's pooled
    value, per pooling kind."""
    if kind in ("add", "sum"):
        return lambda pooled: all_reduce_sum(pooled, group)
    if kind == "mean":
        def merge(pooled):
            cnt = segment_count(batch.batch, batch.num_graphs, weights=batch.node_mask)
            num = all_reduce_sum(pooled * cnt[:, None].to(pooled.dtype), group)
            den = all_reduce_sum(cnt, group)
            return num / torch.clamp(den, min=1e-12)[:, None].to(num.dtype)

        return merge
    if kind in ("max", "min"):
        return lambda pooled: all_reduce_extreme(pooled, group, kind)
    raise ValueError(f"halo partitioning: unsupported graph_pooling {kind!r}")


# -- steps --------------------------------------------------------------------

def bind_halo(model, group=None) -> None:
    """Sum the model's feature-norm statistics over ``group`` (the JAX
    package's ``bn_sync_axis`` on the data axis)."""
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            m.sync_group = group


def _forward(model, hb: LocalHalo, compute_dtype, train: bool, group, generator=None):
    from ..train.step import cast_forward

    kind = model.spec.graph_pooling
    return cast_forward(model, hb.batch, compute_dtype, train=train, generator=generator,
                        layer_hook=make_refresh(hb.send, hb.recv, group),
                        pool_reduce=pool_reduce_fn(kind, hb.batch, group))


def make_halo_train_step(model, compute_dtype: torch.dtype = torch.float32, group=None):
    """``(state, LocalHalo) -> metrics``: the train step over one rank's
    view; every rank holds the union graph's loss, and the gradients are
    averaged over the ranks before the (replicated) optimizer step."""
    from ..train.step import freeze_conv_grads

    validate_halo_support(model.spec)
    bind_halo(model, group)

    def step(state, hb: LocalHalo) -> dict:
        m = state.model
        pred = _forward(m, hb, compute_dtype, True, group, state.generator)
        tot, tasks = m.loss(pred, hb.batch, group=group)
        state.optimizer.zero_grad()
        tot.backward()
        for p in m.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        world = world_of(group)
        if live():
            grads = [p.grad for p in m.parameters()]
            sum_tensors(grads, group)
            for g in grads:
                g.div_(world)
        freeze_conv_grads(m)
        state.optimizer.step()
        state.step += 1
        return {"loss": tot.detach(), "tasks_loss": torch.stack([t.detach() for t in tasks]),
                "num_graphs": hb.batch.graph_mask.sum()}

    return step


def make_halo_eval_step(model, compute_dtype: torch.dtype = torch.float32, group=None):
    """``(state, LocalHalo) -> metrics`` with ``make_eval_step``'s keys; the
    per-head squared errors and counts are the union graph's (node rows
    summed over the ranks, graph rows counted once)."""
    validate_halo_support(model.spec)
    bind_halo(model, group)
    world = world_of(group)
    scale = torch.tensor([1.0 / world if k == "graph" else 1.0
                          for k in model.spec.output_type])

    def eval_step(state, hb: LocalHalo) -> dict:
        m = state.model
        with torch.no_grad():
            pred = _forward(m, hb, compute_dtype, False, group)
            tot, tasks = m.loss(pred, hb.batch, group=group)
            sses, counts = m.head_sse(pred, hb.batch)
            s = scale.to(tot.device)
            return {"loss": tot, "tasks_loss": torch.stack(tasks),
                    "head_sse": all_reduce_sum(torch.stack(sses), group) * s,
                    "head_count": all_reduce_sum(torch.stack(counts), group) * s,
                    "num_graphs": hb.batch.graph_mask.sum()}

    return eval_step


def make_halo_apply(model, compute_dtype: torch.dtype = torch.float32, group=None):
    """``LocalHalo -> per-head outputs``: graph heads replicated ``[G, d]``,
    node heads this rank's ``[N_loc, d]`` (reassemble the ranks' with
    :func:`gather_node_predictions`)."""
    validate_halo_support(model.spec)
    bind_halo(model, group)

    def apply(hb: LocalHalo):
        with torch.no_grad():
            out = _forward(model, hb, compute_dtype, False, group)
        return out[0] if model.spec.var_output else out

    return apply


def gather_node_predictions(stacked: np.ndarray, hbatch: HaloBatch) -> np.ndarray:
    """A node head's ``[D, N_loc, d]`` outputs (the ranks' in rank order) in
    global node order ``[N_real, d]``, from the owned slots' global ids."""
    stacked = np.asarray(stacked)
    node_global = np.asarray(hbatch.node_global)
    n_owned = np.asarray(hbatch.n_owned)
    n_real = int(max(node_global.max(), -1)) + 1
    out = np.zeros((n_real,) + stacked.shape[2:], stacked.dtype)
    for d in range(stacked.shape[0]):
        k = int(n_owned[d])
        out[node_global[d, :k]] = stacked[d, :k]
    return out


__all__ = [
    "HALO_SUPPORTED_CONVS", "HaloBatch", "HaloConfig", "HaloPlan", "LocalHalo", "bind_halo",
    "gather_node_predictions", "halo_boundary_bytes", "halo_config", "halo_config_defaults",
    "halo_enabled", "local_view", "make_halo_apply", "make_halo_eval_step",
    "make_halo_train_step", "make_refresh", "partition_graph_batch", "pool_reduce_fn",
    "put_halo_batch", "replicated_allreduce_bytes", "validate_halo_support",
]
