"""Rank grids and parameter placement over ``torch.distributed``.

Counterpart of ``hydragnn_tpu/parallel/mesh.py``. The JAX package lays its
devices out as a ``(branch, data)`` mesh and lets XLA place every array;
the port runs one process per GPU, so the mesh becomes a grid of ranks
(:class:`RankGrid`): rank ``r`` sits at branch ``r // n_data`` and data
index ``r % n_data``. It places each rank's multibranch batches
(``train/multibranch.py::rank_batches``); the gradient sum spans every
rank, as the JAX package's mesh all-reduce does.

:func:`fsdp_shard_dim` is ``fsdp_param_specs``' rule: a parameter with at
least ``2**14`` entries shards along its largest axis that the data width
divides (the first such axis, largest first); the others stay replicated.
A data width of 1 shards too, into one shard, as a mesh axis of size 1
does. :func:`host_gather` is the layout-neutral state: the full
parameters gathered from the shards.

Tensor parallelism (``make_mesh(n_model)``, ``Architecture.parallelism:
"tensor"``) is a ``(data x model)`` grid of ranks (:class:`TPGrid`): the
model groups are runs of ``n_model`` consecutive ranks (the JAX package
keeps its ``model`` axis innermost, on the fastest links; on one host the
consecutive cards), the data groups stride across them. :func:`tp_shard_dim`
is ``tp_param_specs``' column rule: a parameter with at least ``2**10``
entries whose feature (flax's last) axis the model width divides shards
along that axis.
"""

from __future__ import annotations

import dataclasses

import torch

from .comm import rank_of, world_of

DATA_AXIS = "data"
BRANCH_AXIS = "branch"
MODEL_AXIS = "model"

FSDP_MIN_SIZE = 2 ** 14
TP_MIN_SIZE = 2 ** 10


@dataclasses.dataclass
class RankGrid:
    """This process's place in a ``(branch, data)`` grid of ranks."""

    n_branch: int
    n_data: int
    rank: int

    @property
    def world(self) -> int:
        return self.n_branch * self.n_data

    @property
    def branch_index(self) -> int:
        return self.rank // self.n_data

    @property
    def data_index(self) -> int:
        return self.rank % self.n_data

    @property
    def shape(self) -> dict:
        return {BRANCH_AXIS: self.n_branch, DATA_AXIS: self.n_data}


def make_rank_grid(n_data: int | None = None, n_branch: int = 1) -> RankGrid:
    """This rank's place in a grid over every rank of the default group
    (one rank when none is formed); ``n_data`` defaults to the world over
    ``n_branch``."""
    world = world_of()
    n_branch = max(1, int(n_branch))
    if n_data is None:
        n_data = world // n_branch
    if n_branch * n_data != world:
        raise ValueError(f"rank grid ({n_branch} branch x {n_data} data) != {world} ranks")
    return RankGrid(n_branch=n_branch, n_data=n_data, rank=rank_of())


@dataclasses.dataclass
class TPGrid:
    """This process's place in the ``(data x model)`` grid of the
    tensor-parallel route, and its two process groups (None when no group
    is formed)."""

    n_data: int
    n_model: int
    rank: int
    model_group: object = None
    data_group: object = None

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def make_tp_grid(n_model: int) -> TPGrid:
    """The ``(world / n_model) x n_model`` grid over the default group
    (``make_mesh(n_data, n_model)``): model groups of consecutive ranks,
    data groups strided. Every rank forms every group, in one order, as
    ``torch.distributed.new_group`` asks."""
    import torch.distributed as dist

    from .comm import live

    world, rank = world_of(), rank_of()
    n_model = int(n_model)
    if n_model < 1 or world % n_model:
        raise ValueError(f"tensor_parallel_size={n_model} does not divide the {world} ranks")
    grid = TPGrid(n_data=world // n_model, n_model=n_model, rank=rank)
    if live():
        for d in range(grid.n_data):
            g = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
            if d == grid.data_index:
                grid.model_group = g
        for m in range(n_model):
            g = dist.new_group(list(range(m, world, n_model)))
            if m == grid.model_index:
                grid.data_group = g
    return grid


def tp_shard_dim(shape, n_model: int, min_size: int = TP_MIN_SIZE) -> int | None:
    """The axis ``tp_param_specs`` shards a parameter of ``shape`` along over
    ``n_model`` ranks, or None (replicated): its feature axis, when it has
    at least ``min_size`` entries and ``n_model`` divides that axis. flax's
    feature axis is its last; the port's dense weights are ``[out, in]``,
    so for a matrix it is axis 0 (a vector's is its only axis)."""
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    if not shape or size < min_size:
        return None
    dim = 0 if len(shape) <= 2 else len(shape) - 1
    return dim if shape[dim] % n_model == 0 else None


def fsdp_shard_dim(shape, n_data: int, min_size: int = FSDP_MIN_SIZE) -> int | None:
    """The axis a parameter of ``shape`` shards along over ``n_data``
    ranks, or None (replicated): ``fsdp_param_specs``' rule. The port's
    dense weights are ``[out, in]``, flax's kernels ``[in, out]``: the
    largest axis is the same axis of the layer, and only a square weight
    (whose two axes tie) may pick the other one of the pair."""
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    if not shape or size < min_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % n_data == 0:
            return i
    return None


def host_gather(state) -> dict[str, torch.Tensor]:
    """The full parameters and buffers of a train state as host tensors, by
    name: a sharded parameter's shards all-gathered from every rank (every
    rank must call this), the rest as they are."""
    model = state.model
    layout = getattr(state, "layout", None)
    if layout is not None:
        layout.gather_params()
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


__all__ = ["BRANCH_AXIS", "DATA_AXIS", "FSDP_MIN_SIZE", "MODEL_AXIS", "RankGrid",
           "TPGrid", "TP_MIN_SIZE", "fsdp_shard_dim", "host_gather", "make_rank_grid",
           "make_tp_grid", "tp_shard_dim"]
