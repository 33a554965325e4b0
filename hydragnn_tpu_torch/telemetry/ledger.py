"""Cost observatory over captured graphs: what the steps we replay COST.

Counterpart of ``hydragnn_tpu/telemetry/ledger.py``. The JAX package reads
``Compiled.cost_analysis()`` and ``memory_analysis()`` at every
``aot_compile`` site. The port's counterpart of a compiled executable is a
captured CUDA graph (``capture.py``), and a graph has no cost analysis of
its own, so the ledger counts one eager run of the captured step:

* ``flops`` — what ``torch.utils.flop_counter.FlopCounterMode`` counts over
  the run (its formulas, ``flop_counter.flop_registry``, applied by this
  module's one dispatch mode: the dense products), plus each hand-written
  kernel's own count.
  A kernel call on the card is invisible to the dispatcher, and on the CPU
  its plain version is made of operations the flop counter does not
  count, so every kernel wrapper reports its ``cost(...)`` (FLOPs and
  bytes from its shapes, ``ops/*.py``) through :func:`kernel_region`, on
  either route, and the counters do not see the operations inside it. The
  CPU entry and the card entry of one step and signature have equal
  ``flops``;
* ``bytes_accessed`` — the operand and result bytes of every operation a
  ``TorchDispatchMode`` sees (views excluded), plus the kernels' own
  bytes. The card's step also builds the CSR views the kernels read, which
  the CPU's plain versions do not need, so its bytes run above the CPU's;
* ``peak_bytes`` — on the card and only when ``HYDRAGNN_LEDGER`` names a
  save path, the rise of ``torch.cuda.max_memory_allocated`` over the
  allocation at the start of the capture. Measuring it resets the
  process's peak statistic there (``torch.cuda.reset_peak_memory_stats``),
  so a caller that reads ``max_memory_allocated`` across a capture reads
  the peak since that capture; without the path the statistic is left
  alone and the key is absent, as on the CPU. :func:`diff` skips absent
  keys;
* ``capture_s`` where the JAX entry has ``compile_s``, and
  ``captures_at_capture`` (``capture.total_captures()``) where it has
  ``lowerings_at_capture``.

The key is the JAX package's ``(model, bucket, backend, precision, kind)``,
the document's schema (:data:`SCHEMA_VERSION`) is the JAX package's, and
:func:`diff`, :func:`load`, :func:`maybe_save` and the CLI's ``ledger``
subcommand are the JAX package's, so either package's CLI reads the
other's ledgers.

Capture sites: ``capture.StepGraphs.capture`` (the counted run is the
first warm-up run, which the capture makes anyway), the serving warm-up
and ``warm_quant`` (whose captures are those; on the CPU the warm-up's
eager run is counted), and the one-shot train-step probe of an eager
route (``train/loop.py``), armed only when ``HYDRAGNN_LEDGER`` names a
path. Capture is on whenever the telemetry plane is (``HYDRAGNN_LEDGER=0``
opts out).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..utils import flags
from . import metrics

SCHEMA_VERSION = 1

# metrics the diff sentinel compares (absent-on-this-backend keys skip)
DIFF_METRICS = ("flops", "bytes_accessed", "peak_bytes")

_FALSEY = ("0", "false", "no", "off")
_TRUTHY = ("1", "true", "yes", "on")


def capture_enabled() -> bool:
    """Ledger capture rides the telemetry plane; ``HYDRAGNN_LEDGER=0``
    opts out without touching the rest of the plane."""
    if not metrics.enabled():
        return False
    raw = flags.get(flags.LEDGER)
    return raw is None or str(raw) not in _FALSEY


def save_path() -> str | None:
    """An explicit save target from ``HYDRAGNN_LEDGER``: a path value is
    the target; a bare truthy value means the default ``./logs/
    ledger.json``; unset/falsey means the caller decides (runs with a
    journal still persist next to it)."""
    raw = flags.get(flags.LEDGER)
    if raw is None or str(raw) in _FALSEY:
        return None
    raw = str(raw)
    if raw in _TRUTHY:
        return os.path.join(".", "logs", "ledger.json")
    return raw


def _capture_counts() -> dict:
    from ..capture import total_captures

    return {"captures": int(total_captures())}


# -- counting -----------------------------------------------------------------

# counters open in the process: the kernel wrappers' fast path reads this
# one int and returns when it is 0
_OPEN = 0
_OPEN_LOCK = threading.Lock()


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


class _CountMode(TorchDispatchMode):
    """FLOPs by ``FlopCounterMode``'s formulas, and the operand and result
    bytes of every operation it sees (views move nothing and count
    nothing)."""

    def __init__(self, counter: "CostCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula is not None else 0
        n = 0
        if not func.is_view:
            n = (sum(_tensor_bytes(a) for a in args)
                 + sum(_tensor_bytes(v) for v in kwargs.values()) + _tensor_bytes(out))
        with self.counter._lock:
            self.counter.dense_flops += flops
            self.counter.dense_bytes += n
        return out


class CostCounter:
    """Counts one run: ``with CostCounter() as c: step(...)``, then
    :meth:`result`. Reentrant use is not supported; the counts of the
    operations autograd runs on its own thread (a backward) land here too,
    since the dispatch modes ride the autograd engine's thread state."""

    def __init__(self):
        self._lock = threading.Lock()
        self.dense_flops = 0  # guarded-by: _lock
        self.dense_bytes = 0  # guarded-by: _lock
        self.kernels: dict[str, dict] = {}  # guarded-by: _lock
        self._mode = None

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        with self._lock:
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
            k["calls"] += 1
            k["flops"] += int(flops)
            k["bytes"] += int(nbytes)

    def __enter__(self) -> "CostCounter":
        global _OPEN
        self._mode = _CountMode(self)
        self._mode.__enter__()
        with _OPEN_LOCK:
            _OPEN += 1
        return self

    def __exit__(self, *exc) -> None:
        global _OPEN
        with _OPEN_LOCK:
            _OPEN -= 1
        mode, self._mode = self._mode, None
        mode.__exit__(*exc)

    def result(self) -> dict:
        """``flops`` and ``bytes_accessed`` (dense + kernels), the dense and
        kernel parts, and the per-kernel calls and counts."""
        with self._lock:
            kernels = {k: dict(v) for k, v in sorted(self.kernels.items())}
            dense_flops, dense_bytes = self.dense_flops, self.dense_bytes
        k_flops = sum(v["flops"] for v in kernels.values())
        k_bytes = sum(v["bytes"] for v in kernels.values())
        return {"flops": float(dense_flops + k_flops),
                "bytes_accessed": float(dense_bytes + k_bytes),
                "dense_flops": dense_flops, "kernel_flops": k_flops,
                "dense_bytes": dense_bytes, "kernel_bytes": k_bytes, "kernels": kernels}


def _active_counter():
    """The counter whose dispatch mode is on this thread's mode stack (the
    autograd engine's threads inherit it), or None."""
    if not _OPEN:
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, _CountMode):
            return mode.counter
    return None


@contextlib.contextmanager
def kernel_region(name: str, cost):
    """A hand-written kernel's call (the launch on the card, the plain
    version on the CPU): inside a :class:`CostCounter` the kernel's
    ``cost`` (``(flops, bytes)``, or a callable returning them, evaluated
    only when counting) is added and the operations inside are hidden from
    the counters; otherwise nothing happens."""
    counter = _active_counter()
    if counter is None:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    flops, nbytes = cost() if callable(cost) else cost
    counter.add_kernel(name, flops, nbytes)
    with _disable_current_modes():
        yield


_COUNTED_LOCK = threading.Lock()
_COUNTED = {"runs": 0, "seconds": 0.0}  # guarded-by: _COUNTED_LOCK


def count(fn, *args, **kwargs) -> tuple[object, dict]:
    """``fn(*args, **kwargs)`` run once under a :class:`CostCounter`;
    returns ``(its output, the counts)``. The run's host seconds add to
    :func:`counted_totals`."""
    t0 = time.perf_counter()
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    with _COUNTED_LOCK:
        _COUNTED["runs"] += 1
        _COUNTED["seconds"] += time.perf_counter() - t0
    return out, counter.result()


def counted_totals() -> dict:
    """The process's counted runs so far (:func:`count`): ``runs`` and
    their host ``seconds``, the run included (a capture's counted run takes
    the place of one of its warm-up runs)."""
    with _COUNTED_LOCK:
        return dict(_COUNTED)


# -- the ledger ---------------------------------------------------------------


def entry_key(entry: dict) -> str:
    """The identity a diff matches entries on."""
    return "|".join(str(entry.get(k, "?")) for k in (
        "model", "bucket", "backend", "precision", "kind"))


class CostLedger:
    """In-memory accumulator of per-graph cost entries (thread-safe;
    warm-ups record from dispatcher threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}  # guarded-by: _lock

    def record(self, counts: dict, *, model: str = "?", bucket=None, kind: str = "graph",
               precision: str | None = None, backend: str = "cuda",
               capture_s: float | None = None, peak_bytes: int | None = None,
               extra: dict | None = None) -> dict | None:
        """Record one counted step (``counts``: :meth:`CostCounter.result`)
        under its key (a no-op and None when capture is off). Re-recording
        the same key overwrites: a re-capture measures the same step."""
        if not capture_enabled():
            return None
        entry = {
            "model": str(model),
            "bucket": list(bucket) if isinstance(bucket, (tuple, list))
            else (bucket if bucket is None else str(bucket)),
            "backend": str(backend),
            "precision": str(precision) if precision is not None else "default",
            "kind": str(kind),
            "t_wall": time.time(),
        }
        for key in ("flops", "bytes_accessed", "dense_flops", "kernel_flops", "dense_bytes",
                    "kernel_bytes", "kernels"):
            if key in counts:
                entry[key] = counts[key]
        if peak_bytes is not None:
            entry["peak_bytes"] = int(peak_bytes)
        if capture_s is not None:
            entry["capture_s"] = round(float(capture_s), 4)
        entry["captures_at_capture"] = _capture_counts()["captures"]
        if extra:
            entry.update(extra)
        key = entry_key(entry)
        with self._lock:
            self._entries[key] = entry
        return dict(entry)

    def entries(self) -> list[dict]:
        with self._lock:
            return [dict(self._entries[k]) for k in sorted(self._entries)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()

    def document(self) -> dict:
        """The schema'd ledger document (what ``save`` writes)."""
        return {
            "schema": SCHEMA_VERSION,
            "created_unix": time.time(),
            "backend": "cuda" if torch.cuda.is_available() else "cpu",
            "captures": _capture_counts(),
            "entries": self.entries(),
        }

    def save(self, path: str) -> str | None:
        """Atomically persist the ledger document; empty ledgers write
        nothing (no entries, no file — absence is unambiguous)."""
        doc = self.document()
        if not doc["entries"]:
            return None
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path


def load(path: str) -> dict:
    """Read a ledger document back; raises on unreadable/unschema'd input
    (the diff sentinel wants loud failure, not a silent pass)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "entries" not in doc:
        raise ValueError(f"not a ledger document: {path}")
    return doc


def diff(baseline: dict, current: dict, tolerance: float = 0.02) -> dict:
    """Compare two ledger documents entry-by-entry. An entry REGRESSES
    when any :data:`DIFF_METRICS` value grew beyond ``tolerance``
    (relative); shrinkage is reported as an improvement, never a failure.
    Entries present on one side only are listed but do not fail — a new
    bucket is news, not a regression."""
    base_by = {entry_key(e): e for e in baseline.get("entries", [])}
    cur_by = {entry_key(e): e for e in current.get("entries", [])}
    regressions, improvements, compared = [], [], 0
    for key in sorted(set(base_by) & set(cur_by)):
        b, c = base_by[key], cur_by[key]
        compared += 1
        for metric in DIFF_METRICS:
            bv, cv = b.get(metric), c.get(metric)
            if not isinstance(bv, (int, float)) or not isinstance(cv, (int, float)):
                continue
            if bv <= 0:
                continue
            ratio = cv / bv
            delta = {"key": key, "metric": metric, "baseline": bv,
                     "current": cv, "ratio": round(ratio, 6)}
            if ratio > 1.0 + tolerance:
                regressions.append(delta)
            elif ratio < 1.0 - tolerance:
                improvements.append(delta)
    return {
        "tolerance": tolerance,
        "compared": compared,
        "only_in_baseline": sorted(set(base_by) - set(cur_by)),
        "only_in_current": sorted(set(cur_by) - set(base_by)),
        "regressions": regressions,
        "improvements": improvements,
        "ok": not regressions,
    }


# -- the process ledger -------------------------------------------------------

LEDGER = CostLedger()


def record(counts: dict, **kwargs) -> dict | None:
    return LEDGER.record(counts, **kwargs)


def entries() -> list[dict]:
    return LEDGER.entries()


def reset_ledger() -> None:
    LEDGER.reset()


def save(path: str) -> str | None:
    return LEDGER.save(path)


def maybe_save(default_path: str | None = None) -> str | None:
    """Persist the process ledger to the flag-armed path, else to the
    caller's default (a run's log dir); a no-op when neither names a
    target or the ledger is empty."""
    path = save_path() or default_path
    if path is None:
        return None
    return LEDGER.save(path)


@contextlib.contextmanager
def isolated_ledger():
    """Swap the process ``LEDGER`` for a fresh instance for the duration
    of the scope (same single-rebind pattern as
    ``metrics.isolated_registry``)."""
    global LEDGER
    fresh = CostLedger()
    prev, LEDGER = LEDGER, fresh
    try:
        yield fresh
    finally:
        LEDGER = prev


@contextlib.contextmanager
def measured_capture(device, **key):
    """Around one capture on ``device``: yields a dict whose ``"counts"``
    the capture fills from its counted run (:func:`count`); on exit the
    entry is recorded under ``key`` (``model``, ``bucket``, ``kind``,
    ``precision``) with the capture's seconds and, on the card with
    ``HYDRAGNN_LEDGER`` naming a path, its peak bytes (the process's peak
    statistic is reset for that). Without capture (the plane or the ledger
    off) it yields None and does nothing."""
    if not capture_enabled():
        yield None
        return
    slot: dict = {}
    base = None
    if device.type == "cuda" and save_path() is not None:
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    yield slot
    if "counts" not in slot:
        return
    peak = (torch.cuda.max_memory_allocated(device) - base) if base is not None else None
    record(slot["counts"], backend=device.type, capture_s=time.perf_counter() - t0,
           peak_bytes=peak, **key)


__all__ = [
    "DIFF_METRICS",
    "CostCounter",
    "CostLedger",
    "LEDGER",
    "SCHEMA_VERSION",
    "capture_enabled",
    "count",
    "counted_totals",
    "diff",
    "entries",
    "entry_key",
    "isolated_ledger",
    "kernel_region",
    "load",
    "maybe_save",
    "measured_capture",
    "record",
    "reset_ledger",
    "save",
    "save_path",
]
