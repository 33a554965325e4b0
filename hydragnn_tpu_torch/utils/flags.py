"""Typed registry of the ``HYDRAGNN_*`` runtime flags the port reads.

Counterpart of ``hydragnn_tpu/utils/flags.py``: one ``Flag`` per variable,
one typed accessor (:func:`get`), and the table (:func:`describe`). The
port registers only the flags it reads so far: those of the parallel
layouts (``HYDRAGNN_AUTO_PARALLEL``, ``HYDRAGNN_USE_FSDP``,
``HYDRAGNN_FSDP_STRATEGY``, ``HYDRAGNN_HALO``, ``HYDRAGNN_MASTER_ADDR``,
``HYDRAGNN_MASTER_PORT``) and of the resilience layer
(``HYDRAGNN_NONFINITE_GUARD``, ``HYDRAGNN_FAULT_PLAN``,
``HYDRAGNN_ELASTIC``, ``HYDRAGNN_WATCHDOG_DISPATCH_S``) and of the
telemetry plane (``HYDRAGNN_TELEMETRY``, ``HYDRAGNN_TRACE_EVENTS``,
``HYDRAGNN_TRACE_PROPAGATE``, ``HYDRAGNN_LEDGER``, ``HYDRAGNN_TRACE_LEVEL``,
``HYDRAGNN_COMPILE_SENTINEL``, with the JAX package's defaults), of
population training (``HYDRAGNN_POPULATION``, ``HYDRAGNN_SUPERSTEP``) and
of bulk screening (``HYDRAGNN_SCREEN_PREFETCH``, ``HYDRAGNN_SCREEN_TOPK``).
The JAX package's other overrides (prefetch, workers, serving, the store)
are not read by the port yet.
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

SUPERSTEP = _register(Flag(
    "HYDRAGNN_SUPERSTEP", "int", None,
    "Train steps per dispatch block (overrides Training.steps_per_dispatch; "
    "unset/1 disables): the loader plans the epoch bucket-major in blocks "
    "of K, and each batch of a block replays its bucket's captured step "
    "(train/superstep.py). Per-batch placements and microbatched routes pin "
    "K=1."))
POPULATION = _register(Flag(
    "HYDRAGNN_POPULATION", "int", None,
    "Train N population members (HPO trials / deep-ensemble replicas) as "
    "ONE step by vmapping the train step over a leading member axis "
    "(train/population.py; overrides Training.population.size, unset/0/1 "
    "disables). Composes with HYDRAGNN_SUPERSTEP: one block advances N "
    "members x K steps. Members share the batch stream and differ in init "
    "seed, lr, weight decay and loss weights (runtime tensors, not "
    "constants of the captured step); a NaN/Inf member is reverted in the "
    "step and reported 'diverged' without stalling the rest. Single process, "
    "one device: no data-parallel group, edge sharding or pipeline."))
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

# -- observability (telemetry/) ---------------------------------------------
TELEMETRY = _register(Flag(
    "HYDRAGNN_TELEMETRY", "bool", True,
    "The telemetry plane (hydragnn_tpu_torch.telemetry): typed metrics "
    "registry, structured event journal (logs/<run>/events.jsonl), "
    "correlated trace export and the cost ledger. =0 turns the whole plane "
    "into no-ops (accessors hand out a shared no-op instrument; journal "
    "emits return at once). Overrides Telemetry.enabled."))
TRACE_EVENTS = _register(Flag(
    "HYDRAGNN_TRACE_EVENTS", "bool", False,
    "Record every tracer span (host clock) as a Chrome trace event and let "
    "runs write a perfetto-loadable logs/<run>/trace.json tagged with the "
    "journal's correlation ids. The aggregate span timers (utils/tracer.py) "
    "always run. Overrides Telemetry.trace_events; requires "
    "HYDRAGNN_TELEMETRY on."))
TRACE_PROPAGATE = _register(Flag(
    "HYDRAGNN_TRACE_PROPAGATE", "bool", True,
    "Propagate the ambient trace context (request_id / parent span / "
    "journal correlation ids) across the wire: RoundTripper.request stamps "
    "one optional frame field (_trace_ctx), WireServer extracts it into the "
    "handler's journal scope. =0 sends no field: the frame is byte for "
    "byte the frame without telemetry. Overrides Telemetry.trace_propagate; "
    "requires HYDRAGNN_TELEMETRY on."))
LEDGER = _register(Flag(
    "HYDRAGNN_LEDGER", "str", None,
    "Cost ledger over captured graphs (telemetry/ledger.py). Unset: every "
    "CUDA-graph capture records its FLOPs, bytes and peak memory in memory, "
    "and runs that open a journal persist logs/<run>/ledger.json. "
    "'0'/'false': disable. A path: also save the ledger there after the "
    "serving warm-up, and arm the one-shot train-step probe of an eager "
    "route (diff two ledgers with `python -m hydragnn_tpu_torch.telemetry "
    "ledger`)."))
TRACE_LEVEL = _register(Flag(
    "HYDRAGNN_TRACE_LEVEL", "int", 0,
    "Tracer verbosity: 0 span timers only, >=1 also records a "
    "torch.profiler trace of the first epoch under logs/<run>/profile."))
COMPILE_SENTINEL = _register(Flag(
    "HYDRAGNN_COMPILE_SENTINEL", "str", None,
    "Guard steady-state epochs against new CUDA-graph captures "
    "(analysis/sentinel.py): 'warn' prints the per-epoch capture count "
    "after the warm-up epoch, 'strict' raises RecompileError; unset/0 "
    "disables."))

# -- bulk screening (screen/) -------------------------------------------------
SCREEN_PREFETCH = _register(Flag(
    "HYDRAGNN_SCREEN_PREFETCH", "int", None,
    "Blocks the bulk-screening executor stages ahead of the device "
    "(overrides Screening.prefetch, default 2): a background thread "
    "fetches and collates the next block(s) while the current one computes. "
    "=0 runs fully synchronous; scores are identical either way."))
SCREEN_TOPK = _register(Flag(
    "HYDRAGNN_SCREEN_TOPK", "int", None,
    "Ranked candidates a bulk screen keeps (overrides Screening.topk, "
    "default 16). Ordering is (score desc, index asc): deterministic, so "
    "an interrupted-and-resumed screen reports the bit-identical list."))

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


__all__ = ["AUTO_PARALLEL", "COMPILE_SENTINEL", "ELASTIC", "FAULT_PLAN", "FSDP_STRATEGIES",
           "FSDP_STRATEGY", "Flag", "HALO", "LEDGER", "MASTER_ADDR", "MASTER_PORT",
           "NONFINITE_GUARD", "POPULATION", "SCREEN_PREFETCH", "SCREEN_TOPK", "SUPERSTEP",
           "TELEMETRY", "TRACE_EVENTS", "TRACE_LEVEL", "TRACE_PROPAGATE", "USE_FSDP",
           "WATCHDOG_DISPATCH_S", "describe", "fsdp_mode", "get"]
