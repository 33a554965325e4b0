"""Multi-process bootstrap: rank and world discovery and the process group.

Counterpart of ``hydragnn_tpu/parallel/distributed.py``. The same env
cascade (OpenMPI, SLURM, PBS/Intel MPI) discovers the world and this
process's rank, with torchrun's ``WORLD_SIZE``/``RANK``/``LOCAL_RANK`` where
the JAX package reads ``JAX_NUM_PROCESSES``; the rendezvous host comes from
the scheduler's nodelist and its port from the job id, as in the reference.
:func:`setup_ddp` then forms the ``torch.distributed`` group: one process
per GPU over NCCL (``torch.cuda.set_device(local_rank)`` first), or gloo
when the caller runs on the CPU.

No downgrade: a world above 1 whose group cannot be formed raises. (The
JAX package logs "auto-parallel disabled" and trains on one device; the
port never trains one rank's share of the data alone.)
"""

from __future__ import annotations

import os
import re
import subprocess

import torch

from ..utils import flags


def init_comm_size_and_rank() -> tuple[int, int]:
    """(world size, rank) from the scheduler env cascade (reference
    :113-135), torchrun's variables last; (1, 0) without any."""
    if os.getenv("OMPI_COMM_WORLD_SIZE"):
        return int(os.environ["OMPI_COMM_WORLD_SIZE"]), int(os.environ["OMPI_COMM_WORLD_RANK"])
    if os.getenv("SLURM_NPROCS") and os.getenv("SLURM_PROCID") is not None:
        return int(os.environ["SLURM_NPROCS"]), int(os.environ["SLURM_PROCID"])
    if os.getenv("PMI_SIZE"):  # PBS/Intel MPI
        return int(os.environ["PMI_SIZE"]), int(os.environ["PMI_RANK"])
    if os.getenv("WORLD_SIZE"):  # torchrun
        return int(os.environ["WORLD_SIZE"]), int(os.environ.get("RANK", 0))
    return 1, 0


def local_rank(rank: int) -> int:
    """This process's index among the processes of its node: the
    scheduler's or torchrun's local rank, else ``rank`` modulo the node's
    GPU count."""
    for name in ("OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID", "MPI_LOCALRANKID",
                 "LOCAL_RANK"):
        if os.getenv(name):
            return int(os.environ[name])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank % max(n, 1)


def _first_host_from_nodelist() -> str | None:
    """Rendezvous host from scheduler nodelists (reference :79-110, 191-215)."""
    lsb = os.getenv("LSB_HOSTS")
    if lsb:
        hosts = [h for h in lsb.split() if h and h != "batch"]
        if hosts:
            return hosts[0]
    slurm = os.getenv("SLURM_NODELIST") or os.getenv("SLURM_JOB_NODELIST")
    if slurm:
        try:
            out = subprocess.run(["scontrol", "show", "hostnames", slurm],
                                 capture_output=True, text=True, timeout=10).stdout.split()
            if out:
                return out[0]
        except (OSError, subprocess.TimeoutExpired):
            pass
        # no scontrol: expand "prefix[a-b,...]" by hand
        m = re.match(r"^([^\[]+)\[(\d+)", slurm)
        if m:
            return f"{m.group(1)}{m.group(2)}"
        return slurm.split(",")[0]
    pbs = os.getenv("PBS_NODEFILE")
    if pbs and os.path.exists(pbs):
        with open(pbs) as f:
            first = f.readline().strip()
            if first:
                return first
    return None


def _port_from_job_id(default: int = 8889) -> int:
    """``HYDRAGNN_MASTER_PORT``, else a port derived from the job id
    (reference :171-185), else torchrun's ``MASTER_PORT``, else
    ``default``."""
    port = flags.get(flags.MASTER_PORT)
    if port is not None:
        return int(port)
    job = os.getenv("SLURM_JOB_ID") or os.getenv("LSB_JOBID") or os.getenv("PBS_JOBID")
    if job:
        digits = re.sub(r"\D", "", job) or "0"
        return 10000 + int(digits) % 50000
    if os.getenv("MASTER_PORT"):
        return int(os.environ["MASTER_PORT"])
    return default


def _master_addr() -> str:
    return (flags.get(flags.MASTER_ADDR) or os.getenv("MASTER_ADDR")
            or _first_host_from_nodelist() or "localhost")


def setup_ddp(device="cuda", verbosity: int = 0, init_method: str | None = None
              ) -> tuple[int, int]:
    """Form the process group (the ``setup_ddp`` entry point, reference
    :151-280); returns ``(world size, rank)``. A group formed before (by
    the caller or an earlier call) is kept as it is. With a world of 1 no
    group is formed. ``device``: NCCL for a CUDA device, after
    ``torch.cuda.set_device(local_rank)``; gloo for the CPU.
    ``init_method`` (``tcp://host:port``) overrides the discovered
    rendezvous. A group that cannot be formed raises."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    world, rank = init_comm_size_and_rank()
    if world <= 1:
        return 1, 0
    if not dist.is_available():
        raise RuntimeError(f"world size {world} but torch.distributed is not available")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank(rank))
        backend = "nccl"
    else:
        backend = "gloo"
    init_method = init_method or f"tcp://{_master_addr()}:{_port_from_job_id()}"
    if verbosity > 0:
        print(f"setup_ddp: {backend} world {world} rank {rank} via {init_method}", flush=True)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return dist.get_world_size(), dist.get_rank()


_STORES: list = []  # the rendezvous stores kept alive across re-formed groups


def reform_group(survivors, generation: int, device="cuda") -> int | None:
    """Leave the default group and, on a rank of ``survivors`` (ranks of
    the group being left), join a new one of ``len(survivors)`` ranks, this
    rank the survivors' index of it: the elastic re-mesh
    (``resilience/elastic.py``). Every rank of the old group calls this at
    the same point; the card is drained and a barrier passed before the
    group is destroyed, so no collective is in flight. The new group forms
    over the old one's rendezvous store under the prefix ``elastic/<generation>``
    (rank 0, which serves the store, must survive). Returns the new rank,
    or None on a rank that left."""
    import torch.distributed as dist

    store = dist.distributed_c10d._get_default_store()
    _STORES.append(store)  # keeps the store's server (in rank 0) alive
    backend, rank = dist.get_backend(), dist.get_rank()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()
    survivors = list(survivors)
    if rank not in survivors:
        return None
    new_rank = survivors.index(rank)
    dist.init_process_group(backend, store=dist.PrefixStore(f"elastic/{generation}", store),
                            rank=new_rank, world_size=len(survivors))
    return new_rank


def get_comm_size_and_rank() -> tuple[int, int]:
    """(world size, rank) of the live group, else of the env cascade."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return init_comm_size_and_rank()


__all__ = ["get_comm_size_and_rank", "init_comm_size_and_rank", "local_rank", "reform_group",
           "setup_ddp"]
