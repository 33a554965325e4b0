"""Walltime-aware early stop.

Counterpart of ``hydragnn_tpu/utils/walltime.py`` (reference
``hydragnn/utils/distributed/distributed.py:614-639``): on SLURM the loop
asks how much of the job's time is left and stops before the scheduler
kills the run, so the best checkpoint survives.
"""

from __future__ import annotations

import os
import re
import subprocess
import time


def _parse_slurm_time(s: str) -> float:
    """``[DD-]HH:MM:SS`` or ``MM:SS`` to seconds."""
    days = 0
    if "-" in s:
        d, s = s.split("-", 1)
        days = int(d)
    parts = [int(p) for p in s.split(":")]
    while len(parts) < 3:
        parts.insert(0, 0)
    h, m, sec = parts
    return ((days * 24 + h) * 60 + m) * 60 + sec


def remaining_walltime_seconds() -> float | None:
    """Seconds left in the current SLURM job, or None outside SLURM."""
    job = os.environ.get("SLURM_JOB_ID")
    end = os.environ.get("SLURM_JOB_END_TIME")
    if end:
        try:
            return float(end) - time.time()
        except ValueError:
            pass
    if not job:
        return None
    try:
        out = subprocess.run(["squeue", "-h", "-j", job, "-o", "%L"], capture_output=True,
                             text=True, timeout=10).stdout.strip()
        if out and re.match(r"^[\d:-]+$", out):
            return _parse_slurm_time(out)
    except (OSError, subprocess.TimeoutExpired):
        pass
    return None


def make_walltime_check(margin_seconds: float = 300.0):
    """The loop's ``walltime_check``: True within ``margin_seconds`` of the
    job's end."""

    def check() -> bool:
        rem = remaining_walltime_seconds()
        return rem is not None and rem < margin_seconds

    return check


__all__ = ["make_walltime_check", "remaining_walltime_seconds"]
