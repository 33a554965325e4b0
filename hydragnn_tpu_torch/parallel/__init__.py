"""Parallel training over ``torch.distributed``: one process per GPU.

Counterpart of ``hydragnn_tpu/parallel/``:

* ``distributed``: rank and world discovery, ``setup_ddp`` (NCCL on the
  card, gloo on the CPU), ``reform_group`` (the elastic re-mesh);
* ``mesh``: the ``(branch, data)`` and ``(data x model)`` grids of ranks,
  the FSDP rule and the tensor-parallel column rule;
* ``step``: data-parallel train and eval steps, replicated, FSDP or
  tensor-parallel, with SyncBatchNorm and the graph-count-weighted loss;
* ``tensor``: column-parallel dense layers and feature-sharded activations;
* ``pipeline``: the GPipe stage ring over the ranks;
* ``halo`` (with ``graphs/partition.py``), ``large_graph`` (edge
  sharding) and ``ring_attention``: the three large-graph routes;
* ``comm``: the collectives, with their gradients.
"""

from .comm import live, rank_of, world_of  # noqa: F401
from .distributed import get_comm_size_and_rank, init_comm_size_and_rank, setup_ddp  # noqa: F401
from .mesh import (BRANCH_AXIS, DATA_AXIS, RankGrid, fsdp_shard_dim, host_gather,  # noqa: F401
                   make_rank_grid)
from .step import (make_parallel_eval_step, make_parallel_train_step,  # noqa: F401
                   merge_replica_stats, shard_state)

__all__ = [
    "BRANCH_AXIS",
    "DATA_AXIS",
    "RankGrid",
    "fsdp_shard_dim",
    "get_comm_size_and_rank",
    "host_gather",
    "init_comm_size_and_rank",
    "live",
    "make_parallel_eval_step",
    "make_parallel_train_step",
    "make_rank_grid",
    "merge_replica_stats",
    "rank_of",
    "setup_ddp",
    "shard_state",
    "world_of",
]
