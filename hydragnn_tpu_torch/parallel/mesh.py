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

Tensor parallelism (``tp_param_specs``, ``Architecture.parallelism:
"tensor"``) is not ported: ``run_training`` refuses it.
"""

from __future__ import annotations

import dataclasses

import torch

from .comm import rank_of, world_of

DATA_AXIS = "data"
BRANCH_AXIS = "branch"

FSDP_MIN_SIZE = 2 ** 14


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


__all__ = ["BRANCH_AXIS", "DATA_AXIS", "FSDP_MIN_SIZE", "RankGrid", "fsdp_shard_dim",
           "host_gather", "make_rank_grid"]
