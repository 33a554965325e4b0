"""Span timers + profiling hooks.

Counterpart of ``hydragnn_tpu/utils/tracer.py`` (reference
``hydragnn/utils/profiling_and_tracing/tracer.py``): a lightweight
hierarchical host timer keeping the reference's span names
(``dataload``/``train``/``validate``/``test``, the superstep's
``stage_block``), plus an optional ``torch.profiler`` trace where the JAX
package starts ``jax.profiler``.

Spans are host clock and never wait for the card (no
``torch.cuda.synchronize``): a ``train`` span covers the host's dispatch of
an epoch's steps and the one device-to-host transfer of its metrics at the
end, which does wait for the last step.

Spans are NESTED: each thread keeps an open-span stack, so ``dataload``
inside ``train`` closes innermost-first and, when
``HYDRAGNN_TRACE_EVENTS``/``Telemetry.trace_events`` arms the telemetry
plane, every close emits one Chrome trace-event complete record
(``hydragnn_tpu_torch.telemetry.trace``) tagged with the journal's
correlation ids.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

from ..telemetry import trace as _trace


class Timer:
    __slots__ = ("count", "total", "t0", "running")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.t0 = 0.0
        self.running = False

    def start(self):
        if not self.running:
            self.t0 = time.perf_counter()
            self.running = True

    def stop(self):
        if self.running:
            self.total += time.perf_counter() - self.t0
            self.count += 1
            self.running = False


_timers: dict[str, Timer] = defaultdict(Timer)
_profiler = None  # the running torch.profiler session and its directory
# per-thread open-span stack [(name, t0_perf, t0_wall), ...] — threads never
# share spans, so nesting needs no lock
_spans = threading.local()


def initialize(trace_dir: str | None = None, enable_profiler: bool = False) -> bool:
    """Start a ``torch.profiler`` trace (host and, with a card, CUDA
    activity) that :func:`save` or :func:`stop_profiler` writes to
    ``trace_dir``; returns whether one started."""
    global _profiler
    if not (enable_profiler and trace_dir) or _profiler is not None:
        return False
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _profiler = (prof, trace_dir)
    return True


def stop_profiler() -> str | None:
    """Stop the running profiler session and write its Chrome trace as
    ``<trace_dir>/profile.pt.trace.json``; returns the path (None when no
    session runs)."""
    global _profiler
    if _profiler is None:
        return None
    prof, trace_dir = _profiler
    _profiler = None
    prof.stop()
    path = os.path.join(trace_dir, f"profile.p{_process_index()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def _process_index() -> int:
    from ..parallel.comm import rank_of

    return rank_of()


def _span_stack() -> list:
    stack = getattr(_spans, "stack", None)
    if stack is None:
        stack = _spans.stack = []
    return stack


def start(name: str, **_ignored):
    _timers[name].start()
    _span_stack().append((name, time.perf_counter(), time.time()))


def stop(name: str, **_ignored):
    _timers[name].stop()
    stack = _span_stack()
    # pop the INNERMOST open span of this name (spans close LIFO in the
    # loop's usage; the search keeps a stray out-of-order stop from
    # corrupting unrelated open spans)
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] == name:
            _, t0_perf, t0_wall = stack.pop(i)
            if _trace.trace_enabled():
                _trace.add_span(name, t0_wall, time.perf_counter() - t0_perf)
            break


@contextlib.contextmanager
def span(name: str):
    start(name)
    try:
        yield
    finally:
        stop(name)


def timed_iter(iterable, name: str = "dataload"):
    """``iterable``'s items, the host's wait for each in a ``name`` span
    (the reference's GPTL dataload region)."""
    it = iter(iterable)
    end = object()
    while True:
        start(name)
        item = next(it, end)
        stop(name)
        if item is end:
            return
        yield item


def profile(name: str):
    """Decorator wrapping a function in a span (reference ``@tr.profile``)."""

    def deco(fn):
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def reset():
    _timers.clear()


@contextlib.contextmanager
def isolated_timers():
    """Swap the process-global aggregate ``Timer`` registry for a fresh
    one for the duration of the scope — the tracer half of
    ``telemetry.isolate()``."""
    global _timers
    fresh: dict[str, Timer] = defaultdict(Timer)
    prev, _timers = _timers, fresh
    try:
        yield fresh
    finally:
        _timers = prev


def get(name: str) -> Timer:
    return _timers[name]


def summary() -> dict[str, dict]:
    return {
        k: {"count": t.count, "total_s": t.total, "avg_s": t.total / max(t.count, 1)}
        for k, t in sorted(_timers.items())
    }


def save(path: str = "./logs/", prefix: str = "timing"):
    """Dump per-process timing json (the reference writes ``gp_timing.p{rank}``)
    and stop a running profiler session."""
    stop_profiler()
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"{prefix}.p{_process_index()}.json"), "w") as f:
        json.dump(summary(), f, indent=2)


def print_timers(verbosity_level: int = 0):
    from .print_utils import print_master

    for name, stats in summary().items():
        print_master(
            f"[timer] {name}: total {stats['total_s']:.3f}s over {stats['count']} calls "
            f"(avg {stats['avg_s'] * 1e3:.2f} ms)"
        )
