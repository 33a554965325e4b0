"""Supersteps: ``Training.steps_per_dispatch`` = K train steps per block.

Counterpart of ``hydragnn_tpu/train/superstep.py``. The JAX package folds K
train steps into one ``lax.scan`` over a ``[K, ...]`` block, so the host
dispatches once per K batches. On the card the port's train step is
already one launch from the host, a replay of its CUDA graph
(``capture.py``), so a block replays the bucket's one-step graph once per
batch. A K-step graph was measured against it on an H100 (``chip_smoke.py``:
2.415 against 2.157 ms per step at the qm9 top bucket) and dropped: it
saved no launch worth its copy of K batches before the replay, and it
doubled the captured train graphs per bucket.

What K keeps is the JAX loader's plan: ``GraphLoader.set_superstep`` orders
the epoch bucket-major (``PrefetchLoader.set_superstep`` passes it on and
buffers a block ahead), so a K-step run trains on the batches, in the order,
of the JAX package's K-step run. Under a process group the plan is the JAX
grouped loader's: blocks of K groups of ``world`` batches, each group one
bucket, and every rank replays its slot's captured data-parallel step, the
NCCL all-reduce inside each. A block is the epoch loop's unit of dispatch:
the resilience layer polls stop requests and fires faults per block, and a
mid-epoch checkpoint records whole blocks.

Contracts (``tests/test_torch_superstep.py`` on the CPU,
``tests/test_torch_capture_gpu.py`` on the card):

* **Exact parity**: a block leaves the state (parameters, running
  statistics, optimizer moments and step count, dropout generator) and the
  metrics bit-identical to its single train steps, in fp32.
* **The trailing partial block**: the JAX package fills the epoch's last
  block with masked batches and selects the old state back after each fill
  step. The port's blocks have no fixed length: the tail is its real
  batches, and the state after it is the state after training on them
  only, by construction.

``HYDRAGNN_SUPERSTEP`` overrides ``Training.steps_per_dispatch``, as in
the JAX package.

A population (``train/population.py``) composes with K > 1 unchanged: its
step is one captured graph per bucket that advances all N members, and a
block replays it once per batch, so one block advances N members x K
steps. The JAX package selects the old state back after each fill step of
a block with an ``[N]`` keep; the port's blocks have no fill steps, and the
population step reverts a diverged member itself.

Telemetry (``train/loop.py``): each block's host staging (its K batches
from the prefetcher) is a ``stage_block`` span, each batch's wait a
``dataload`` span inside it, and each block a ``dispatch_block`` journal
record, as in the JAX package; a span closes on the host clock and waits
for nothing on the card.
"""

from __future__ import annotations

from ..capture import Dispatch


def resolve_steps_per_dispatch(training_cfg: dict) -> int:
    """K: ``HYDRAGNN_SUPERSTEP``, else ``Training.steps_per_dispatch``
    (unset, 0 or 1: one step per dispatch)."""
    from ..utils import flags

    k = flags.get(flags.SUPERSTEP, default=int(training_cfg.get("steps_per_dispatch", 1) or 1))
    return max(1, int(k or 1))


class Superstep:
    """``(state, batches) -> per-step metrics``: a block of batches (any
    iterable), each through the train step's :class:`~..capture.Dispatch`
    (on the card a replay of its bucket's graph, on the CPU the eager
    step). ``k`` is the block length the loader plans for."""

    def __init__(self, train_step, k: int, collective: bool = False, ledger: dict | None = None):
        self.k = max(1, int(k))
        self.dispatch = Dispatch(train_step, "train", train=True, collective=collective,
                                 ledger=ledger)

    def __call__(self, state, batches) -> list[dict]:
        return [self.dispatch(state, b) for b in batches]


def make_superstep(train_step, k: int, collective: bool = False,
                   ledger: dict | None = None) -> Superstep:
    """The superstep of ``train_step`` (``(state, batch) -> metrics``, the
    eager step) over blocks of ``k`` batches; ``collective`` and ``ledger``:
    see :class:`~..capture.Dispatch`."""
    return Superstep(train_step, k, collective, ledger)


__all__ = ["Superstep", "make_superstep", "resolve_steps_per_dispatch"]
