"""Chrome trace-event export: spans -> perfetto-loadable ``trace.json``.

Counterpart of ``hydragnn_tpu/telemetry/trace.py`` (the port's own copy).
Spans are host clock: a span that closes does not wait for the card, so a
``train`` span covers the host's dispatch of the epoch and its one
metrics transfer at the end, not the device time of each step.

``utils/tracer.py`` keeps the reference's aggregate span timers
(count/total/avg per region). This module adds the TIMELINE view: every
span open/close pair becomes one Chrome trace-event *complete* ("X")
record — name, microsecond timestamp + duration, pid/tid, and the
process-wide correlation ids (epoch/step/recovery_id) as ``args`` — so
loading ``logs/<run>/trace.json`` into Perfetto / ``chrome://tracing``
shows nested train/dataload/validate spans on the training thread next to
serve dispatcher activity, correlated by the SAME ids the event journal
records carry.

Off by default (``HYDRAGNN_TRACE_EVENTS=1`` / ``Telemetry.trace_events``
arms it); disabled, the tracer pays one boolean check per span close. The
buffer is bounded (``MAX_EVENTS``): a week-long serving process cannot
leak memory through its own telemetry — overflow increments a drop
counter the save reports instead of silently truncating.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading

from ..utils import flags
from . import metrics
from .journal import get_context

# Telemetry.trace_events config override (None = follow the env flag);
# same atomic-assignment pattern as metrics._ENABLED_OVERRIDE
_TRACE_OVERRIDE: bool | None = None

MAX_EVENTS = 200_000


def set_trace_enabled(value: bool | None) -> None:
    global _TRACE_OVERRIDE
    _TRACE_OVERRIDE = None if value is None else bool(value)


def trace_enabled() -> bool:
    """Trace-event recording is armed AND the telemetry plane is live."""
    if not metrics.enabled():
        return False
    if _TRACE_OVERRIDE is not None:
        return _TRACE_OVERRIDE
    return bool(flags.get(flags.TRACE_EVENTS))


class TraceBuffer:
    """Bounded in-memory trace-event sink (thread-safe)."""

    def __init__(self, max_events: int = MAX_EVENTS):
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._events: list[dict] = []  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock

    def add_complete(
        self, name: str, ts_s: float, dur_s: float,
        tid: int | None = None, args: dict | None = None,
    ) -> None:
        """One complete ("X") event; timestamps in SECONDS (converted to
        the trace format's microseconds here, once)."""
        event = {
            "name": str(name),
            "ph": "X",
            "ts": ts_s * 1e6,
            "dur": max(dur_s, 0.0) * 1e6,
            "pid": os.getpid(),
            "tid": int(tid if tid is not None else threading.get_ident()),
        }
        if args:
            event["args"] = dict(args)
        with self._lock:
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            self._events.append(event)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def save(self, path: str) -> str:
        """Write the Chrome trace-event JSON object form
        (``{"traceEvents": [...]}`` — what Perfetto and chrome://tracing
        both load). Returns the path."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": dropped},
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


BUFFER = TraceBuffer()


def add_span(name: str, ts_s: float, dur_s: float,
             args: dict | None = None) -> None:
    """Record one closed span as a trace event, tagged with the ambient
    correlation ids (explicit ``args`` win). The tracer calls this only
    when :func:`trace_enabled` — callers needn't re-check."""
    merged = get_context()
    if args:
        merged.update(args)
    BUFFER.add_complete(name, ts_s, dur_s, args=merged or None)


def trace_events() -> list[dict]:
    return BUFFER.events()


def save_trace(path: str) -> str:
    return BUFFER.save(path)


def reset_trace() -> None:
    BUFFER.reset()


@contextlib.contextmanager
def isolated_buffer():
    """Swap the process-global span ``BUFFER`` for a fresh instance for
    the duration of the scope (same single-rebind pattern as
    ``metrics.isolated_registry``) — trace-event count assertions become
    safe under any suite ordering."""
    global BUFFER
    fresh = TraceBuffer()
    prev, BUFFER = BUFFER, fresh
    try:
        yield fresh
    finally:
        BUFFER = prev


__all__ = [
    "BUFFER",
    "MAX_EVENTS",
    "TraceBuffer",
    "add_span",
    "isolated_buffer",
    "reset_trace",
    "save_trace",
    "set_trace_enabled",
    "trace_enabled",
    "trace_events",
]
