"""Append-only structured event journal: ``logs/<run>/events.jsonl``.

Counterpart of ``hydragnn_tpu/telemetry/journal.py`` (the port's own copy):
the record schema is the JAX package's, so either package's CLI reads the
other's journals.

One schema'd JSON record per line, one line per event — epoch ends,
superstep dispatch blocks, guard skips, rollbacks, elastic recovery phases,
fleet failovers, sheds, autotune adoptions, quant certifications. Every
record carries:

* ``seq`` — a per-journal monotonic sequence number assigned under the
  writer lock in file order, so post-hoc tooling can prove ordering even
  when wall clocks step;
* ``t_wall`` — wall time (``time.time()``; durations inside records come
  from monotonic clocks, the wall stamp is for humans and cross-process
  correlation only);
* **correlation ids** — ``run_id`` plus whatever the process-wide context
  carries (``epoch`` / ``step`` / ``recovery_id``, set by the train loop and
  the elastic controller via :func:`set_context`), so "what happened during
  that recovery" is one ``grep recovery_id`` after the fact.

Durability contract: the file is opened line-buffered and each record is
written as ONE ``write()`` of a newline-terminated string, so a SIGKILL
tears at most the final line — :func:`read_journal` tolerates exactly that
(a torn tail is dropped, intact records all parse).

The module keeps one ACTIVE journal (``open_journal``/``close_journal``);
:func:`emit` routes to it and is a cheap no-op when no journal is open or
telemetry is disabled — subsystems emit unconditionally and pay nothing in
processes that never opened a journal (benches, unit tests, serving-only
deployments that want metrics but no event log).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from . import metrics

# -- correlation context ------------------------------------------------------

_CTX_LOCK = threading.Lock()
_CONTEXT: dict = {}  # guarded-by: _CTX_LOCK (epoch / step / recovery_id ...)
_TLS = threading.local()  # per-thread scoped overlay (thread-confined, no lock)


def set_context(**ids) -> None:
    """Merge correlation ids into the process-wide context every later
    record carries; a ``None`` value REMOVES the key (so the elastic
    controller can retire a ``recovery_id`` once the run is healthy)."""
    with _CTX_LOCK:
        for key, value in ids.items():
            if value is None:
                _CONTEXT.pop(key, None)
            else:
                _CONTEXT[key] = value


def get_context() -> dict:
    """Process-wide context merged under the calling thread's scoped
    overlay (see :func:`scoped_context`) — a request id set for one
    dispatch thread never leaks into a concurrent handler's records."""
    with _CTX_LOCK:
        ctx = dict(_CONTEXT)
    overlay = getattr(_TLS, "overlay", None)
    if overlay:
        ctx.update(overlay)
    return ctx


def clear_context() -> None:
    with _CTX_LOCK:
        _CONTEXT.clear()
    _TLS.overlay = None


@contextlib.contextmanager
def scoped_context(**ids):
    """Overlay correlation ids for the CURRENT THREAD only, restored on
    exit. This is how per-request ids (``request_id`` / ``parent_span``)
    ride through concurrent server handler and dispatcher threads without
    clobbering each other: each thread sees the process-wide context plus
    its own overlay. Nests — inner scopes merge over outer ones; a
    ``None`` value removes the key for the duration of the scope."""
    prev = getattr(_TLS, "overlay", None)
    merged = dict(prev or {})
    for key, value in ids.items():
        if value is None:
            merged.pop(key, None)
        else:
            merged[key] = value
    _TLS.overlay = merged
    try:
        yield
    finally:
        _TLS.overlay = prev


# -- the journal --------------------------------------------------------------


def _jsonable(obj):
    """JSON fallback for numpy scalars/arrays and anything exotic — a
    telemetry write must never throw TypeError into a training loop."""
    try:
        import numpy as np

        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
    except Exception:
        pass
    return str(obj)


# Bounded-staleness flush pacing: appends go to the text buffer and a
# flush runs at most once per window, so hot-path emits (a traced fleet
# predict writes ~5 records across router + replica) stay syscall-free —
# a per-record flush put ~0.3 ms of write + GIL churn on every request.
# A SIGKILL loses at most one window of buffered records plus one torn
# line; ``close()`` (and atexit via ``close_journal``) flushes the rest.
_FLUSH_S = 0.2


class EventJournal:
    """One open ``events.jsonl`` writer. Thread model: ``emit`` may be
    called from the training thread, watchdog/monitor threads, and serve
    dispatchers concurrently; ``_lock`` serializes seq assignment + the
    single line write, so seq order and file order provably agree.
    Durability: records become visible on disk within :data:`_FLUSH_S`
    seconds (or at ``close()``), not per record — post-mortem readers
    already tolerate a torn tail line."""

    def __init__(self, path: str, run_id: str | None = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.run_id = run_id
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: _lock
        self._f = open(path, "a")  # guarded-by: _lock
        # 0.0 = flush on the very first emit, so the file shows life early
        self._next_flush = 0.0  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock

    def emit(self, kind: str, **fields) -> int | None:
        """Append one record; returns its seq (None when already closed).
        Context ids merge in under explicit fields (an explicit ``epoch=``
        beats the ambient one)."""
        rec = {"kind": str(kind), "t_wall": time.time()}
        if self.run_id is not None:
            rec["run_id"] = self.run_id
        rec.update(get_context())
        for key, value in fields.items():
            if value is not None:
                rec[key] = value
        with self._lock:
            if self._closed:
                return None
            rec["seq"] = self._seq
            self._seq += 1
            self._f.write(json.dumps(rec, default=_jsonable) + "\n")
            now = time.monotonic()
            if now >= self._next_flush:
                self._f.flush()
                self._next_flush = now + _FLUSH_S
            return rec["seq"]

    def flush(self) -> None:
        """Push buffered records to disk now (e.g. before reading the
        file back while the journal stays open)."""
        with self._lock:
            if not self._closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.close()


_JOURNAL_LOCK = threading.Lock()
_ACTIVE: EventJournal | None = None  # guarded-by: _JOURNAL_LOCK (reads racy-ok)


def open_journal(
    log_name: str | None = None,
    path: str = "./logs",
    file: str | None = None,
    run_id: str | None = None,
) -> EventJournal:
    """Open (and make ACTIVE) the run's journal at
    ``<path>/<log_name>/events.jsonl`` (or an explicit ``file``). An
    already-active journal is closed first — one process, one event log."""
    if file is None:
        if log_name is None:
            raise ValueError("open_journal needs log_name (or an explicit file=)")
        file = os.path.join(path, log_name, "events.jsonl")
    if run_id is None:
        base = log_name or os.path.basename(os.path.dirname(file)) or "run"
        run_id = f"{base}-{os.getpid()}"
    journal = EventJournal(file, run_id=run_id)
    global _ACTIVE
    with _JOURNAL_LOCK:
        prev, _ACTIVE = _ACTIVE, journal
    if prev is not None:
        prev.close()
    return journal


def close_journal() -> None:
    global _ACTIVE
    with _JOURNAL_LOCK:
        prev, _ACTIVE = _ACTIVE, None
    if prev is not None:
        prev.close()


def active_journal() -> EventJournal | None:
    return _ACTIVE


@contextlib.contextmanager
def isolated():
    """Swap out the ACTIVE journal, the process-wide context, and the
    calling thread's overlay for the duration of the scope — the journal
    half of :func:`hydragnn_tpu_torch.telemetry.isolate`. Anything opened inside
    the scope is closed on exit; the previous journal/context come back
    untouched."""
    global _ACTIVE
    with _JOURNAL_LOCK:
        prev_active, _ACTIVE = _ACTIVE, None
    with _CTX_LOCK:
        prev_ctx = dict(_CONTEXT)
        _CONTEXT.clear()
    prev_overlay = getattr(_TLS, "overlay", None)
    _TLS.overlay = None
    try:
        yield
    finally:
        close_journal()
        with _JOURNAL_LOCK:
            _ACTIVE = prev_active
        with _CTX_LOCK:
            _CONTEXT.clear()
            _CONTEXT.update(prev_ctx)
        _TLS.overlay = prev_overlay


def emit(kind: str, **fields) -> int | None:
    """Route one event to the active journal; a no-op (one attribute read)
    when no journal is open or telemetry is disabled."""
    journal = _ACTIVE
    if journal is None or not metrics.enabled():
        return None
    return journal.emit(kind, **fields)


def read_journal(path: str) -> list[dict]:
    """Parse an ``events.jsonl`` back into records, tolerating the torn
    tail the durability contract permits: an undecodable FINAL line is
    dropped silently; an undecodable line elsewhere (should not happen
    under the one-write-per-line contract) is skipped too rather than
    poisoning the whole read — post-mortem tooling wants every intact
    record, not an exception."""
    records: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


__all__ = [
    "EventJournal",
    "active_journal",
    "clear_context",
    "close_journal",
    "emit",
    "get_context",
    "isolated",
    "open_journal",
    "read_journal",
    "scoped_context",
    "set_context",
]
