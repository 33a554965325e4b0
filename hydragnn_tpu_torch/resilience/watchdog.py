"""Hung-dispatch watchdog: a deadline around the host's blocking waits.

Counterpart of ``hydragnn_tpu/resilience/watchdog.py``. A wedged
interconnect or a deadlocked collective does not crash a run: it parks the
host in a device sync with no output, and a scheduler then burns the job's
walltime in silence. The watchdog arms a deadline around each blocking wait
(the epoch loop's reads of the step metrics, a store's replica round-trip);
a region that outlives it gets a warning and its callbacks from a monitor
thread while the waiting thread is still blocked. It does not interrupt a
device sync (NCCL mid-collective cannot be interrupted safely); a guard's
``on_expire`` may act where acting is safe (the store severs a byte-dribbling
peer's socket, ``datasets/sharded.py``).

One daemon monitor thread serves every guard of a :class:`Watchdog`,
started at the first guard and parked on a condition variable while nothing
is armed. The armed deadlines are a table keyed by a token per guard, so
guards may nest and run from many threads at once (a store's prefetch
workers), each firing at most once.
"""

from __future__ import annotations

import itertools
import threading
import time
import warnings
from contextlib import contextmanager


class Watchdog:
    """``with watchdog.guard("what"): <blocking wait>`` calls ``on_hang(what)``
    (and warns) when the region outlives ``timeout_s``; a guard's own
    ``on_expire()`` runs too. A timeout of 0 or less disables it."""

    def __init__(self, timeout_s: float, on_hang=None):
        self.timeout_s = float(timeout_s)
        self.on_hang = on_hang
        self.fired = 0  # guarded-by: _cond
        self.events: list[str] = []  # guarded-by: _cond
        self._cond = threading.Condition()
        self._token = itertools.count()
        self._armed: dict[int, tuple[float, str, object]] = {}  # guarded-by: _cond
        self._thread: threading.Thread | None = None  # guarded-by: _cond

    @contextmanager
    def guard(self, what: str = "device sync", on_expire=None):
        if self.timeout_s <= 0:
            yield
            return
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._monitor, name="hydragnn-watchdog",
                                                daemon=True)
                self._thread.start()
            tok = next(self._token)
            self._armed[tok] = (time.monotonic() + self.timeout_s, what, on_expire)
            self._cond.notify()
        try:
            yield
        finally:
            with self._cond:
                self._armed.pop(tok, None)
                self._cond.notify()

    def _monitor(self) -> None:  # daemon thread
        while True:
            with self._cond:
                if not self._armed:
                    self._cond.wait()
                    continue
                now = time.monotonic()
                expired = [(tok, what, cb) for tok, (t, what, cb) in self._armed.items()
                           if t <= now]
                if not expired:
                    self._cond.wait(min(t for t, _, _ in self._armed.values()) - now)
                    continue
                # each expired region fires once; the next guard re-arms
                for tok, _, _ in expired:
                    self._armed.pop(tok, None)
                self.fired += len(expired)
                self.events.extend(what for _, what, _ in expired)
            for _, what, on_expire in expired:
                warnings.warn(f"watchdog: {what} exceeded {self.timeout_s:.1f}s — a dispatch or "
                              "round-trip appears hung (wedged interconnect, deadlocked "
                              "collective?)", stacklevel=2)
                for cb in (on_expire, self.on_hang):
                    if cb is None:
                        continue
                    try:
                        cb(what) if cb is self.on_hang else cb()
                    except Exception:
                        pass  # a broken callback must not kill the monitor


__all__ = ["Watchdog"]
