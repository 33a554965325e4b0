"""Request queue with admission control for the serving tier.

Counterpart of ``hydragnn_tpu/serve/admission.py``. Load-shedding is typed:
every rejection is its own exception class, so clients can tell "queue
full — back off" from "this request can never be served". The queue is a
deque + condition variable because the micro-batcher needs push-back to the
head (a request that would overflow the batch keeps its place) and
drain-on-shutdown (pending futures fail loudly instead of hanging).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

from ..graphs.graph import GraphSample


class AdmissionError(RuntimeError):
    """Base class of every typed serving rejection."""


class QueueFullError(AdmissionError):
    """Bounded queue at capacity — load shed at admission; retry later."""


class DeadlineExceededError(AdmissionError):
    """The request's deadline passed before its batch dispatched."""


class OversizeError(AdmissionError):
    """The sample does not fit the largest padding bucket of the endpoint,
    or exceeds its per-graph node bound, so no amount of waiting can serve
    it."""


class IncompatibleSampleError(AdmissionError):
    """The sample's feature widths do not match the endpoint's signature
    (e.g. the wrong input feature count)."""


class UnknownModelError(AdmissionError):
    """Request routed to a model name the server does not host."""


class ServerClosedError(AdmissionError):
    """The server was stopped while the request waited in queue."""


@dataclass
class Request:
    """One in-flight prediction request: a single graph + its result slot."""

    sample: GraphSample
    future: Future = field(default_factory=Future)
    deadline: Optional[float] = None  # absolute time.monotonic() instant
    enqueued_at: float = field(default_factory=time.monotonic)

    def expired(self, now: float | None = None) -> bool:
        return self.deadline is not None and (now or time.monotonic()) >= self.deadline

    def claim(self) -> bool:
        """Transition the future to RUNNING; False if the client already
        cancelled it. MUST be called before resolving from server threads —
        an unguarded ``set_result``/``set_exception`` on a cancelled future
        raises ``InvalidStateError`` and would kill the dispatcher."""
        return self.future.set_running_or_notify_cancel()

    def reject(self, exc: BaseException) -> bool:
        """Claim-then-fail; returns False (and does nothing) if the client
        cancelled first. Safe from any server thread."""
        if not self.claim():
            return False
        self.future.set_exception(exc)
        return True


class RequestQueue:
    """Bounded FIFO of :class:`Request` with blocking get and head push-back."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._q: deque[Request] = deque()  # guarded-by: _lock
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False  # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def put(self, req: Request) -> None:
        """Admit or shed: a full queue raises :class:`QueueFullError`
        immediately (bounded depth IS the backpressure signal — blocking
        producers would just move the unbounded buffer into their threads)."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("server is stopped")
            if len(self._q) >= self.depth:
                raise QueueFullError(
                    f"queue at capacity ({self.depth}); request shed"
                )
            self._q.append(req)
            self._nonempty.notify()

    def get(self, timeout: float | None = None) -> Request | None:
        """Pop the oldest request, blocking up to ``timeout`` seconds.
        Returns ``None`` on timeout or when the queue is closed and empty."""
        with self._lock:
            if timeout is None:
                while not self._q and not self._closed:
                    self._nonempty.wait()
            else:
                end = time.monotonic() + timeout
                while not self._q and not self._closed:
                    remaining = end - time.monotonic()
                    if remaining <= 0 or not self._nonempty.wait(remaining):
                        break
            return self._q.popleft() if self._q else None

    def push_back(self, req: Request) -> None:
        """Return a request to the HEAD (it was popped but does not fit the
        batch being formed) — keeps FIFO order for the next batch."""
        with self._lock:
            self._q.appendleft(req)
            self._nonempty.notify()

    def close(self) -> list[Request]:
        """Stop admitting, wake every waiter, return the drained backlog so
        the caller can fail its futures."""
        with self._lock:
            self._closed = True
            drained = list(self._q)
            self._q.clear()
            self._nonempty.notify_all()
        return drained


__all__ = [
    "AdmissionError",
    "QueueFullError",
    "DeadlineExceededError",
    "IncompatibleSampleError",
    "OversizeError",
    "UnknownModelError",
    "ServerClosedError",
    "Request",
    "RequestQueue",
]
