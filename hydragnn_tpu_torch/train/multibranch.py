"""Multibranch (multidataset) training: the branch loaders.

Counterpart of ``hydragnn_tpu/train/multibranch.py`` (numpy only; the port
keeps its own copy). N datasets train one shared encoder with one decoder
branch each; the model routes every graph to its branch by its
``dataset_id`` (``models/base.py``), so one device trains all branches on
mixed batches through ``run_training``, as the JAX package can.

* :func:`concat_multidataset` tags each dataset's samples with its branch
  id and concatenates them;
* :class:`OversamplingLoader` draws each epoch's indices with replacement
  to a fixed size (the reference's ``RandomSampler(replacement=True)``);
* :func:`make_branch_loaders` gives one such loader per branch, sized to
  the largest branch and sharing one pad bucket;
* :func:`interleave_branch_batches` yields one batch per branch per step;
* :func:`branch_device_batches` yields, per step, ``n_data`` distinct
  batches of each branch in row-major (branch, data) order, the layout of a
  ``parallel.mesh.RankGrid``; :func:`rank_batches` keeps one rank's. All
  ranks train one data-parallel step over the whole grid (the gradient
  all-reduce spans every rank, as the JAX package's mesh all-reduce does),
  and a branch's decoder gets gradients only from its own graphs.
"""

from __future__ import annotations

import numpy as np

from ..graphs.batching import GraphLoader, PadSpec, compute_pad_spec
from ..graphs.graph import GraphSample


def concat_multidataset(datasets: dict[str, list] | list[list]) -> list[GraphSample]:
    """Tag each source dataset's samples with its branch ``dataset_id`` (its
    position) and concatenate them."""
    items = list(datasets.items()) if isinstance(datasets, dict) else \
        [(f"dataset-{i}", d) for i, d in enumerate(datasets)]
    out = []
    for branch, (_name, samples) in enumerate(items):
        for s in samples:
            s.dataset_id = branch
            out.append(s)
    return out


class OversamplingLoader(GraphLoader):
    """A shuffling loader whose epoch draws ``num_samples`` indices with
    replacement from the seed ``seed + epoch``, the draw every process
    shares (a multiple of ``world`` long), as the JAX loader draws it."""

    def __init__(self, samples, batch_size: int, num_samples: int, **kw):
        super().__init__(samples, batch_size, shuffle=True, **kw)
        self.num_samples = int(num_samples)

    def _full_permutation(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self.epoch)
        total = self.num_samples
        if self.world > 1:
            total = int(np.ceil(total / self.world) * self.world)
        return rng.choice(len(self.samples), size=total, replace=True)


def make_branch_loaders(datasets: dict[str, list] | list[list], batch_size: int,
                        seed: int = 0, min_samples: int = 0
                        ) -> tuple[list[GraphLoader], PadSpec]:
    """One oversampling loader per branch (seed ``seed + 31 i``), all over
    one pad bucket of every branch's samples, each sized to the largest
    branch (at least ``min_samples``) so every branch takes the same number
    of steps per epoch."""
    branches = list(datasets.values()) if isinstance(datasets, dict) else list(datasets)
    pad = compute_pad_spec(concat_multidataset(datasets), batch_size)
    target = max(max(len(b) for b in branches), min_samples)
    loaders = [OversamplingLoader(b, batch_size, num_samples=target, pad=pad, seed=seed + 31 * i)
               for i, b in enumerate(branches)]
    return loaders, pad


def interleave_branch_batches(loaders: list[GraphLoader], epoch: int):
    """Per step, ``[branch 0's batch, branch 1's batch, ...]`` of epoch
    ``epoch``, for as many steps as the shortest loader gives."""
    for ld in loaders:
        ld.set_epoch(epoch)
    iters = [iter(ld) for ld in loaders]
    for _ in range(min(len(ld) for ld in loaders)):
        yield [next(it) for it in iters]


def branch_device_batches(loaders: list[GraphLoader], epoch: int, n_data: int):
    """Per step, ``n_data`` distinct batches of each branch in row-major
    order (branch 0's, then branch 1's, ...) for a (branch, data) grid, for
    as many whole steps as the shortest loader gives."""
    for ld in loaders:
        ld.set_epoch(epoch)
    iters = [iter(ld) for ld in loaders]
    for _ in range(min(len(ld) for ld in loaders) // n_data):
        step = []
        for it in iters:
            step.extend(next(it) for _ in range(n_data))
        yield step


def rank_batches(loaders: list[GraphLoader], epoch: int, grid):
    """The batches of :func:`branch_device_batches` that rank ``grid.rank``
    of a ``parallel.mesh.RankGrid`` trains, one per step."""
    for step in branch_device_batches(loaders, epoch, grid.n_data):
        yield step[grid.rank]


__all__ = ["OversamplingLoader", "branch_device_batches", "concat_multidataset",
           "interleave_branch_batches", "make_branch_loaders", "rank_batches"]
