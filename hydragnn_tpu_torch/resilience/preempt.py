"""Preemption handler: SIGTERM and SIGUSR1 become a checkpoint request.

Counterpart of ``hydragnn_tpu/resilience/preempt.py``. SLURM preemption
sends SIGTERM (or the ``--signal=USR1@k`` a user asks for) ahead of the hard
kill. The handler only sets a flag; the epoch loop polls it at dispatch
boundaries, saves a mid-epoch checkpoint (the loader position in its
sidecar, ``train/checkpoint.py``) and stops, so at most one dispatch of work
is lost. The loop uninstalls the handlers in a ``finally``.
"""

from __future__ import annotations

import signal
import threading


class PreemptionHandler:
    """Install with :meth:`install`, poll :attr:`requested`, and always
    :meth:`uninstall` (the previous handlers come back)."""

    SIGNALS = ("SIGTERM", "SIGUSR1")

    def __init__(self):
        self._event = threading.Event()
        self._prev: dict[int, object] = {}
        self._installed = False

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        for name in self.SIGNALS:
            signum = getattr(signal, name, None)
            if signum is None:
                continue
            try:
                self._prev[signum] = signal.signal(signum, self._on_signal)
            except (ValueError, OSError):
                # not the main thread: a programmatic request still works
                continue
        self._installed = True
        return self

    def uninstall(self) -> None:
        for signum, prev in self._prev.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False

    def _on_signal(self, signum, frame) -> None:  # signal context: the flag only
        self._event.set()

    def request(self) -> None:
        """A programmatic checkpoint request (the elastic controller's drain
        channel): the loop sees it as it sees a delivered SIGTERM."""
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def clear(self) -> None:
        self._event.clear()


__all__ = ["PreemptionHandler"]
