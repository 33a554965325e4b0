"""Parallel training over ``torch.distributed``: one process per GPU.

Counterpart of ``hydragnn_tpu/parallel/``:

* ``distributed``: rank and world discovery, ``setup_ddp`` (NCCL on the
  card, gloo on the CPU);
* ``mesh``: the ``(branch, data)`` grid of ranks and the FSDP rule;
* ``step``: data-parallel train and eval steps, replicated or FSDP, with
  SyncBatchNorm and the graph-count-weighted loss;
* ``halo`` (with ``graphs/partition.py``), ``large_graph`` (edge
  sharding) and ``ring_attention``: the three large-graph routes;
* ``comm``: the collectives, with their gradients.

Tensor parallelism and the GPipe pipeline are the next slice.
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
