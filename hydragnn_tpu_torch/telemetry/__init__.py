"""The unified telemetry plane: metrics registry + event journal + traces.

Counterpart of ``hydragnn_tpu/telemetry``: one queryable source of truth
over the port's train -> serve -> recover stack, its records, ledger and
wire field the JAX package's, so either package's CLI reads the other's
files and a port peer and a JAX peer correlate over the wire:

* :mod:`~hydragnn_tpu_torch.telemetry.metrics` — thread-safe typed
  Counter/Gauge/Histogram registry with label sets; ``snapshot()`` is the
  stable dict the fleet ``metrics`` wire op ships;
* :mod:`~hydragnn_tpu_torch.telemetry.journal` — the append-only structured
  event journal (``logs/<run>/events.jsonl``): one schema'd record per
  epoch / dispatch block / guard skip / rollback / recovery phase /
  failover / shed, each carrying monotonic seq + wall time + correlation
  ids (run_id/epoch/step/recovery_id);
* :mod:`~hydragnn_tpu_torch.telemetry.trace` — Chrome trace-event export of the
  tracer's nested spans (perfetto-loadable ``trace.json``), tagged with
  the same correlation ids;
* :mod:`~hydragnn_tpu_torch.telemetry.ledger` — the cost ledger over
  captured CUDA graphs (``logs/<run>/ledger.json``);
* :mod:`~hydragnn_tpu_torch.telemetry.propagation` — the trace context a
  wire frame carries;
* ``python -m hydragnn_tpu_torch.telemetry <events.jsonl>`` — the post-mortem
  CLI (:mod:`~hydragnn_tpu_torch.telemetry.cli`).

``HYDRAGNN_TELEMETRY=0`` turns the whole plane into near-zero-cost no-ops;
``HYDRAGNN_TRACE_EVENTS=1`` (or ``Telemetry.trace_events``) additionally
records the span timeline. :func:`configure` applies a validated
``Telemetry`` config block process-wide (env flags still win, folded in by
``TelemetryConfig.apply_env``).
"""

from __future__ import annotations

import contextlib

from . import ledger, propagation
from .config import TelemetryConfig, telemetry_config_defaults
from .journal import (
    EventJournal,
    active_journal,
    clear_context,
    close_journal,
    emit,
    get_context,
    open_journal,
    read_journal,
    scoped_context,
    set_context,
)
from .ledger import CostLedger
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NOOP,
    REGISTRY,
    counter,
    enabled,
    gauge,
    histogram,
    publish,
    reset_metrics,
    set_enabled,
    snapshot,
)
from .propagation import new_request_id, propagate_enabled, set_propagate_enabled
from .trace import (
    add_span,
    reset_trace,
    save_trace,
    set_trace_enabled,
    trace_enabled,
    trace_events,
)


def configure(cfg: "TelemetryConfig | dict | None") -> "TelemetryConfig | None":
    """Apply a ``Telemetry`` config block process-wide (``None`` resets
    every override to follow the env flags). Returns the applied config."""
    if cfg is None:
        set_enabled(None)
        set_trace_enabled(None)
        set_propagate_enabled(None)
        return None
    if not isinstance(cfg, TelemetryConfig):
        cfg = TelemetryConfig.from_config(cfg)
    cfg.validate()
    set_enabled(cfg.enabled)
    set_trace_enabled(cfg.trace_events)
    set_propagate_enabled(cfg.trace_propagate)
    return cfg


@contextlib.contextmanager
def isolate():
    """Scoped FRESH-INSTANCE isolation of every process-global telemetry
    surface: metrics registry, trace buffer, tracer timers, cost ledger,
    active journal + correlation context, and the config overrides. The
    previous state is fully restored on exit — the ``telemetry_isolate``
    pytest fixture wraps this, so absolute-count assertions hold under
    any suite ordering without reset band-aids."""
    from ..utils import tracer as _tracer
    from . import journal as _journal, metrics as _metrics, trace as _trace

    prev_enabled = _metrics._ENABLED_OVERRIDE
    prev_trace = _trace._TRACE_OVERRIDE
    prev_prop = propagation._PROPAGATE_OVERRIDE
    with _metrics.isolated_registry(), _trace.isolated_buffer(), \
            _tracer.isolated_timers(), ledger.isolated_ledger(), \
            _journal.isolated():
        try:
            yield
        finally:
            _metrics.set_enabled(prev_enabled)
            _trace.set_trace_enabled(prev_trace)
            propagation.set_propagate_enabled(prev_prop)


__all__ = [
    "CostLedger",
    "Counter",
    "EventJournal",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NOOP",
    "REGISTRY",
    "TelemetryConfig",
    "active_journal",
    "add_span",
    "clear_context",
    "close_journal",
    "configure",
    "counter",
    "emit",
    "enabled",
    "gauge",
    "get_context",
    "histogram",
    "isolate",
    "ledger",
    "new_request_id",
    "open_journal",
    "propagate_enabled",
    "propagation",
    "publish",
    "read_journal",
    "reset_metrics",
    "reset_trace",
    "save_trace",
    "scoped_context",
    "set_context",
    "set_enabled",
    "set_propagate_enabled",
    "set_trace_enabled",
    "snapshot",
    "telemetry_config_defaults",
    "trace_enabled",
    "trace_events",
]
