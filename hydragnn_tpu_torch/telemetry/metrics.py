"""Thread-safe typed metrics registry: Counter / Gauge / Histogram.

Counterpart of ``hydragnn_tpu/telemetry/metrics.py``, which imports no JAX:
the port keeps its own copy, so both packages publish the same series
under the same names and labels, and a fleet of either package answers the
``metrics`` wire op with the same snapshot shape.

* **typed instruments** — :class:`Counter` (monotonic), :class:`Gauge`
  (set-valued), :class:`Histogram` (count/sum/min/max + exponential latency
  buckets), each addressed by ``(name, sorted label set)`` so
  ``counter("serve_requests", model="gin", event="shed")`` names exactly one
  series no matter the call site;
* **near-zero disabled cost** — with ``HYDRAGNN_TELEMETRY=0`` (or a
  ``Telemetry`` config block with ``enabled: false`` applied via
  :func:`set_enabled`) every accessor returns the shared no-op instrument,
  whose ``inc``/``set``/``observe`` are empty methods;
* **stable snapshots** — :meth:`MetricsRegistry.snapshot` returns a fresh
  plain dict (sorted names, sorted ``k=v`` label strings) safe to JSON-dump,
  diff across time, or ship over the fleet wire ``metrics`` op.

The ``stats()`` surfaces (server, router, replica, answer cache, sharded
store) keep their shapes: they dual-write their counters here and mirror
derived values via :func:`publish`, which turns a stats dict's numeric
leaves into gauges without touching the dict.

Every counter is incremented on the host, by the caller of a step: a
Python increment inside a captured CUDA graph would run once, at capture.
"""

from __future__ import annotations

import contextlib
import threading

from ..utils import flags

# process-wide override from the validated Telemetry config block (None =
# follow the HYDRAGNN_TELEMETRY env flag). Plain assignment of an immutable
# is atomic in CPython; readers tolerate staleness by design — instruments
# handed out before a flip keep their behavior, documented below.
_ENABLED_OVERRIDE: bool | None = None


def set_enabled(value: bool | None) -> None:
    """Process-level enable override (``telemetry.configure`` routes the
    config block here); ``None`` returns control to the env flag."""
    global _ENABLED_OVERRIDE
    _ENABLED_OVERRIDE = None if value is None else bool(value)


def enabled() -> bool:
    """Is the telemetry plane live? Checked at instrument CREATION (a
    disabled registry hands out no-ops; re-enabling mid-run affects only
    instruments requested afterwards) and per journal emit."""
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    return bool(flags.get(flags.TELEMETRY))


class _NoopInstrument:
    """The disabled-path singleton: every mutator is an empty method, so a
    cached ``counter(...)`` handle costs one attribute call and a pass."""

    __slots__ = ()

    def inc(self, by: int = 1) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0


NOOP = _NoopInstrument()


class Counter:
    """Monotonic event count. ``inc`` with a negative delta raises — a
    counter that can go down is a gauge wearing the wrong type."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0  # guarded-by: _lock

    def inc(self, by: int = 1) -> None:
        if by < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (inc by {by}); "
                "use a gauge for set-valued series"
            )
        with self._lock:
            self._value += by

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def _snapshot_value(self):
        return self.value


class Gauge:
    """Last-written value (queue depth, cache bytes, loss, ...)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0  # guarded-by: _lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += float(by)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _snapshot_value(self):
        return self.value


# default boundaries sized for serving/step latencies in SECONDS; the +Inf
# overflow bucket is implicit (count - sum(buckets))
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)


class Histogram:
    """Distribution summary: count/sum/min/max plus cumulative-style bucket
    counts over fixed boundaries (``le`` semantics, Prometheus-shaped)."""

    __slots__ = ("name", "labels", "bounds", "_lock", "_count", "_sum",
                 "_min", "_max", "_buckets")

    def __init__(self, name: str, labels: tuple, bounds=DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.bounds = tuple(sorted(float(b) for b in bounds))
        self._lock = threading.Lock()
        self._count = 0  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock
        self._min = None  # guarded-by: _lock
        self._max = None  # guarded-by: _lock
        self._buckets = [0] * len(self.bounds)  # guarded-by: _lock

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._buckets[i] += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._count

    def _snapshot_value(self):
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "buckets": {
                    repr(b): n for b, n in zip(self.bounds, self._buckets)
                },
            }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class MetricsRegistry:
    """The instrument table: get-or-create by ``(kind, name, labels)``.

    Thread model: ``_lock`` serializes table MUTATION only — the accessor
    hot path is a lock-free dict read (GIL-atomic; instruments are never
    removed except by ``reset()``), so per-request counting from fleet
    dispatchers/serve workers doesn't serialize on one process mutex.
    Value updates ride each instrument's own lock, and a ``snapshot()``
    mid-churn sees each series at some consistent point (never a torn
    value)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict = {}  # guarded-by: _lock (reads lock-free)

    def _get(self, kind: str, name: str, labels: dict, **kw):
        if not enabled():
            return NOOP
        key = (name, _label_key(labels))
        inst = self._instruments.get(key)  # lock-free fast path (hot)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = _KINDS[kind](name, key[1], **kw)
                    self._instruments[key] = inst
        if not isinstance(inst, _KINDS[kind]):
            raise ValueError(
                f"metric {name!r} {_label_str(key[1])!r} already exists "
                f"as a {type(inst).__name__}, requested as a {kind} — "
                "one series, one type"
            )
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, bounds=DEFAULT_BUCKETS, **labels) -> Histogram:
        return self._get("histogram", name, labels, bounds=bounds)

    def snapshot(self) -> dict:
        """A fresh, stable, JSON-safe dict: ``{"counters": {name: {labels:
        value}}, "gauges": ..., "histograms": ...}`` with names and label
        strings sorted, so two snapshots diff line-by-line."""
        with self._lock:
            items = list(self._instruments.items())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        section = {Counter: "counters", Gauge: "gauges",
                   Histogram: "histograms"}
        for (name, lkey), inst in sorted(items):
            out[section[type(inst)]].setdefault(name, {})[_label_str(lkey)] = (
                inst._snapshot_value()
            )
        return out

    def reset(self) -> None:
        """Drop every instrument (tests; a fresh process state)."""
        with self._lock:
            self._instruments.clear()


# the process-wide default registry every wired subsystem publishes into
REGISTRY = MetricsRegistry()


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, bounds=DEFAULT_BUCKETS, **labels) -> Histogram:
    return REGISTRY.histogram(name, bounds=bounds, **labels)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset_metrics() -> None:
    REGISTRY.reset()


@contextlib.contextmanager
def isolated_registry():
    """Swap the process-global ``REGISTRY`` for a FRESH instance for the
    duration of the scope, restoring the previous one on exit. Because the
    module-level ``counter()``/``gauge()``/``histogram()``/``snapshot()``
    helpers read the global at call time, everything inside the scope —
    including code in other threads started inside it — lands in the fresh
    registry, so absolute-count assertions are safe under any suite
    ordering (no reset band-aids needed). The swap is a single attribute
    rebind (atomic under the GIL); concurrent readers see either registry,
    never a torn state."""
    global REGISTRY
    fresh = MetricsRegistry()
    prev, REGISTRY = REGISTRY, fresh
    try:
        yield fresh
    finally:
        REGISTRY = prev


def publish(prefix: str, stats: dict, **labels) -> None:
    """Mirror a ``stats()`` dict's numeric leaves into gauges
    (``{prefix}_{key}``) without touching the dict — the bridge that lets
    the five pre-existing ad-hoc stats surfaces keep their test-pinned
    shapes byte-for-byte while still publishing through the registry.
    Non-numeric leaves (lists, nested dicts, strings, None) are skipped;
    bools are skipped too (a flag is not a measurement)."""
    if not enabled():
        return
    for key, value in stats.items():
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        REGISTRY.gauge(f"{prefix}_{key}", **labels).set(value)


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "NOOP",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "enabled",
    "isolated_registry",
    "publish",
    "reset_metrics",
    "set_enabled",
    "snapshot",
]
