"""One retry policy for the wire transport.

Counterpart of ``hydragnn_tpu/utils/retry.py``: a frozen ``RetryPolicy``
plus ``call_with_retries``, so "how many attempts, how long between them,
what counts as transient" is decided once. Jitter is multiplicative
(``delay * (1 + U(0, jitter))``): when a peer dies every client notices at
the same moment, and synchronized retries would re-stampede its
replacement in lockstep.
"""

from __future__ import annotations

import dataclasses
import random
import time
import warnings
from typing import Callable


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` total tries (1 = no retrying); sleep before retry k
    (1-based) is ``base_delay * factor**(k-1) * (1 + U(0, jitter))``."""

    attempts: int = 3
    base_delay: float = 0.05
    factor: float = 2.0
    jitter: float = 1.0

    def delay(self, retry_no: int) -> float:
        scale = 1.0 + random.random() * self.jitter
        return self.base_delay * (self.factor ** (retry_no - 1)) * scale


def call_with_retries(fn: Callable, *, policy: RetryPolicy,
                      retry_on: tuple = (ConnectionError, OSError), give_up: tuple = (),
                      describe: str = "", hint: str = ""):
    """Run ``fn()``; on an exception in ``retry_on`` (and not in
    ``give_up``), sleep per the policy and retry, warning each time, up to
    ``policy.attempts`` total attempts. The last failure re-raises."""
    attempt = 0
    while True:
        try:
            return fn()
        except give_up:
            raise
        except retry_on as e:
            attempt += 1
            if attempt >= policy.attempts:
                raise
            sleep_s = policy.delay(attempt)
            warnings.warn(
                f"{describe or 'operation'} failed ({type(e).__name__}: {e}); retry "
                f"{attempt}/{policy.attempts - 1} in {sleep_s:.2f}s"
                + (f" ({hint})" if hint else "")
            )
            time.sleep(sleep_s)


__all__ = ["RetryPolicy", "call_with_retries"]
