"""Verbosity-gated printing + logging (reference
``hydragnn/utils/print/print_utils.py``).

Counterpart of ``hydragnn_tpu/utils/print_utils.py``: ``print_distributed``
prints on rank 0 of the process group only (every process is rank 0 when
no group is formed), like the reference's rank-0 gating.
"""

from __future__ import annotations

import logging
import os


def _process_index() -> int:
    from ..parallel.comm import rank_of

    return rank_of()


def print_master(*args, **kwargs):
    if _process_index() == 0:
        print(*args, **kwargs)


def print_distributed(verbosity_level: int, *args, **kwargs):
    """Print on rank 0 (the reference prints at every level through
    print_master; the gate stays permissive)."""
    if _process_index() == 0:
        print(*args, **kwargs)


def device_memory_summary() -> str:
    """Per-card memory: bytes the caching allocator holds for tensors now
    and at its peak (``torch.cuda.memory_stats``), the reference's per-rank
    peak-GPU-memory print (``distributed.py:566-581``)."""
    import torch

    if not torch.cuda.is_available():
        return "device memory stats unavailable (no CUDA device)"
    lines = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        in_use = stats.get("allocated_bytes.all.current")
        peak = stats.get("allocated_bytes.all.peak")
        if in_use is None and peak is None:
            continue
        fields = []
        if in_use is not None:
            fields.append(f"in_use {in_use / 2**20:.0f} MiB")
        if peak is not None:
            fields.append(f"peak {peak / 2**20:.0f} MiB")
        lines.append(f"cuda:{i}: " + ", ".join(fields))
    return "; ".join(lines) or "device memory stats unavailable (no allocation yet)"


def iterate_tqdm(iterable, verbosity_level: int, desc: str = "", total=None):
    """Progress-bar iteration at verbosity >= 2 (reference ``iterate_tqdm``);
    the plain iterable where tqdm is not installed."""
    if verbosity_level >= 2 and _process_index() == 0:
        try:
            from tqdm import tqdm

            return tqdm(iterable, desc=desc, total=total)
        except ImportError:
            pass
    return iterable


def setup_log(log_name: str, path: str = "./logs/") -> logging.Logger:
    """Rank-tagged file logger at ``<path>/<run>/run.log`` (reference
    ``print_utils.py:62-111``)."""
    run_dir = os.path.join(path, log_name)
    os.makedirs(run_dir, exist_ok=True)
    logger = logging.getLogger(f"hydragnn_tpu_torch.{log_name}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(os.path.join(run_dir, "run.log"))
        fh.setFormatter(
            logging.Formatter(f"%(asctime)s [p{_process_index()}] %(message)s")
        )
        logger.addHandler(fh)
    return logger
