"""Typed registry of the ``HYDRAGNN_*`` runtime flags the port reads.

Counterpart of ``hydragnn_tpu/utils/flags.py``: one ``Flag`` per variable,
one typed accessor (:func:`get`), and the table (:func:`describe`). The
port registers only the flags it reads so far: those of the parallel
layouts (``HYDRAGNN_AUTO_PARALLEL``, ``HYDRAGNN_USE_FSDP``,
``HYDRAGNN_FSDP_STRATEGY``, ``HYDRAGNN_HALO``, ``HYDRAGNN_MASTER_ADDR``,
``HYDRAGNN_MASTER_PORT``) and of the resilience layer
(``HYDRAGNN_NONFINITE_GUARD``, ``HYDRAGNN_FAULT_PLAN``,
``HYDRAGNN_ELASTIC``, ``HYDRAGNN_WATCHDOG_DISPATCH_S``). The JAX package's
other overrides (prefetch, workers, supersteps, serving, the store) are not
read by the port yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Flag:
    name: str
    kind: str  # bool | int | float | str
    default: object
    help: str


_REGISTRY: dict[str, Flag] = {}


def _register(flag: Flag) -> Flag:
    _REGISTRY[flag.name] = flag
    return flag


AUTO_PARALLEL = _register(Flag(
    "HYDRAGNN_AUTO_PARALLEL", "bool", True,
    "run_training forms the torch.distributed group of a world above 1 and "
    "trains in it (=0: each process trains alone, unless its caller formed "
    "a group)."))
HALO = _register(Flag(
    "HYDRAGNN_HALO", "bool", None,
    "Force halo-exchange graph partitioning on/off (overrides "
    "Architecture.halo.enabled)."))
USE_FSDP = _register(Flag(
    "HYDRAGNN_USE_FSDP", "bool", False,
    "Shard parameters and optimizer state over the data ranks, ZeRO-3 style "
    "(reference distributed.py:429-436)."))
FSDP_STRATEGY = _register(Flag(
    "HYDRAGNN_FSDP_STRATEGY", "str", "FULL_SHARD",
    "FULL_SHARD -> parameter and optimizer sharding; NO_SHARD -> replicated "
    "(reference distributed.py:435-437; SHARD_GRAD_OP and HYBRID_SHARD map "
    "to FULL_SHARD)."))
MASTER_ADDR = _register(Flag(
    "HYDRAGNN_MASTER_ADDR", "str", None,
    "Rendezvous host of torch.distributed (reference :158)."))
MASTER_PORT = _register(Flag(
    "HYDRAGNN_MASTER_PORT", "int", None,
    "Rendezvous port; default derived from the job id (reference :171-219)."))

NONFINITE_GUARD = _register(Flag(
    "HYDRAGNN_NONFINITE_GUARD", "bool", None,
    "Force the non-finite step guard on/off (overrides "
    "Training.resilience.nonfinite_guard). The guard keeps the incoming "
    "state of a step whose loss, parameters, running statistics or "
    "optimizer state is not finite, on the device (resilience/guard.py), and "
    "escalates to rollback with an LR cut after N consecutive skips."))
FAULT_PLAN = _register(Flag(
    "HYDRAGNN_FAULT_PLAN", "str", None,
    "Deterministic fault-injection plan (resilience/chaos.py): a JSON list "
    "of events or @/path/to/plan.json. Faults: nan_batch, sigterm, hang, "
    "corrupt_latest, dead_shard, slow_peer, device_loss, mesh_shrink, "
    "double_fault; the serving fleet's replica_kill, replica_slow and "
    "rollout_during_load are parsed and refused. resilience/campaign.py "
    "composes them into seeded multi-fault schedules."))
ELASTIC = _register(Flag(
    "HYDRAGNN_ELASTIC", "bool", None,
    "In-process elastic recovery (resilience/elastic.py; overrides "
    "Training.resilience.elastic, default off). On device_loss/mesh_shrink, "
    "SIGTERM or a hung-dispatch expiry every rank drains at one dispatch "
    "boundary and checkpoints; the survivors form a smaller process group "
    "and finish the epoch on the saved update grid. Pipeline, tensor, halo "
    "and edge-sharded layouts take the restart-fallback policy."))
WATCHDOG_DISPATCH_S = _register(Flag(
    "HYDRAGNN_WATCHDOG_DISPATCH_S", "float", None,
    "Per-dispatch hang deadline in seconds (overrides "
    "Training.resilience.watchdog_dispatch_s; unset/0 disables), armed "
    "around every train dispatch but a segment's first (which captures its "
    "graphs). Expiry warns, and under elastic recovery becomes a "
    "recoverable fault."))

FSDP_STRATEGIES = frozenset({"FULL_SHARD", "SHARD_GRAD_OP", "HYBRID_SHARD", "NO_SHARD"})


def _parse(flag: Flag, raw: str):
    if flag.kind == "bool":
        return raw not in ("0", "false", "False")
    if flag.kind == "int":
        return int(raw)
    if flag.kind == "float":
        return float(raw)
    return raw


_UNSET = object()


def get(flag: Flag, default=_UNSET):
    """Typed read of one flag; ``default`` overrides the registry default.
    An empty-but-set variable counts as unset."""
    raw = os.getenv(flag.name)
    if raw is None or raw == "":
        return flag.default if default is _UNSET else default
    return _parse(flag, raw)


def fsdp_mode() -> str:
    """``"fsdp"`` when ``HYDRAGNN_USE_FSDP`` asks for sharding with a
    strategy other than ``NO_SHARD``, else ``"replicated"``; an unknown
    strategy raises ``ValueError`` whether or not FSDP is asked for by
    ``HYDRAGNN_USE_FSDP`` (as the JAX package validates it)."""
    strategy = str(get(FSDP_STRATEGY)).upper()
    if get(USE_FSDP) and strategy not in FSDP_STRATEGIES:
        raise ValueError(f"HYDRAGNN_FSDP_STRATEGY={strategy!r} not one of "
                         f"{sorted(FSDP_STRATEGIES)}")
    return "fsdp" if get(USE_FSDP) and strategy != "NO_SHARD" else "replicated"


def describe() -> str:
    """Human-readable flag table."""
    return "\n".join(f"{name:30s} [{f.kind}, default={f.default!r}] {f.help}"
                     for name, f in sorted(_REGISTRY.items()))


__all__ = ["AUTO_PARALLEL", "ELASTIC", "FAULT_PLAN", "FSDP_STRATEGIES", "FSDP_STRATEGY", "Flag",
           "HALO", "MASTER_ADDR", "MASTER_PORT", "NONFINITE_GUARD", "USE_FSDP",
           "WATCHDOG_DISPATCH_S", "describe", "fsdp_mode", "get"]
