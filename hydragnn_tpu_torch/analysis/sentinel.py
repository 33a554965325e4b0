"""Runtime capture sentinel.

Counterpart of ``hydragnn_tpu/analysis/sentinel.py``. The JAX package
counts jit lowerings through ``jax.monitoring``; the port's counterpart of
a lowering is a CUDA-graph capture (``capture.py``: one per step and
batch signature), so this module counts ``capture.total_captures()``. A
capture after warm-up means a batch signature the warm-up did not see (a
bucket, a dtype, a sortedness certificate), and it costs a capture's
warm-up runs on the hot path.

The epoch loop's ``HYDRAGNN_COMPILE_SENTINEL=warn|strict``
(``train/loop.py``) reads :func:`compile_counts` per epoch and journals a
``compile_sentinel`` record whose field keeps the JAX name
``new_lowerings`` (the CLI reads it); its value is the epoch's new
captures. On the CPU no step is captured and the count stays 0. The JAX
package's ``no_recompile(0)`` region guard is ``capture.no_new_captures``.
"""

from __future__ import annotations


class RecompileError(RuntimeError):
    """The strict sentinel saw a capture after the warm-up epoch."""


def compile_counts() -> dict[str, int]:
    """Process-lifetime counts: ``captures`` (CUDA graphs captured)."""
    from ..capture import total_captures

    return {"captures": total_captures()}


__all__ = ["RecompileError", "compile_counts"]
