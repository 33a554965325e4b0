"""``hydragnn_tpu_torch.analysis`` — the runtime capture sentinel.

Counterpart of ``hydragnn_tpu/analysis``. Only its runtime side is ported
so far: the epoch loop's ``HYDRAGNN_COMPILE_SENTINEL`` counts new
CUDA-graph captures, where the JAX package counts jit lowerings, and
``capture.no_new_captures`` is the port of ``no_recompile(0)``. The static
rules (GL001-GL007, GL101-GL107) and the lock-order sanitizer are not
ported.
"""

from .sentinel import RecompileError, compile_counts

__all__ = ["RecompileError", "compile_counts"]
