"""Non-finite step guard: a NaN or Inf step is skipped on the device.

Counterpart of ``hydragnn_tpu/resilience/guard.py``. One NaN loss poisons a
run: the gradient is NaN, AdamW writes NaN into every parameter and moment,
and every later step trains noise. The guard sits inside the step:

* :func:`wrap_step_with_guard` wraps any ``(state, batch) -> metrics`` train
  step (one device, data-parallel, FSDP, tensor, pipeline, MLIP). Before the
  step it copies the incoming state, every floating tensor the step may
  change (parameters, running statistics, the optimizer's shards and state,
  its step counts), into one flat scratch buffer per dtype; after it, one
  probe asks whether the loss and the new state are all finite, and one
  ``torch.where`` per dtype keeps the new state or the incoming one, copied
  back into the state's own tensors in place. No host sync and no branch:
  on the card the whole of it is captured in the step's CUDA graph with the
  step, so a skipped step costs no recapture. A finite step keeps the bits
  it computed (``where`` selects them unchanged); an optimizer state that the
  step created (the first step of ``torch.optim``'s optimizers) is zeroed on
  a skip, as it would have been made. A skipped step's metrics are zeroed
  (``num_graphs`` 0: the epoch's weighted means ignore it, as a fill batch)
  and it adds ``skipped`` = 1; the loop takes the skips back off the host
  step count when it reads the epoch's metrics. The dropout generator moves
  on as it does for any step.
* :class:`SkipTracker` escalates on the host: it reads each dispatch's
  ``skipped`` only once ``lag`` later dispatches have been queued, so it
  never waits on a step in flight, and raises :class:`DivergenceDetected`
  after ``max_consecutive`` skips in a row; the loop answers with a rollback
  to the last good checkpoint with a cut learning rate, and after
  ``max_rollbacks`` with :class:`TrainingDivergedError`.

The state of a process group's ranks is one state (the gradients are summed
before the update, the tensor-parallel shards gathered after it), so every
rank takes the same decision.
"""

from __future__ import annotations

import itertools
from collections import deque

import torch


class DivergenceDetected(RuntimeError):
    """The skip streak reached ``max_consecutive_skips``: the run is
    diverging. Raised on the host; the epoch loop rolls back."""


class TrainingDivergedError(RuntimeError):
    """Rollback with a cut learning rate was tried ``max_rollbacks`` times and
    the run still makes non-finite steps."""


def state_tensors(state) -> list[torch.Tensor]:
    """Every floating tensor a train step may change, in a fixed order: the
    model's parameters and buffers, the optimizer's parameters that are not
    the model's (FSDP and tensor-parallel shards), and the optimizer's
    state tensors, parameter by parameter."""
    model, optimizer = state.model, state.optimizer
    out = [t for t in itertools.chain(model.parameters(), model.buffers())
           if t.is_floating_point()]
    known = {id(t) for t in out}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    out += [p for p in params if id(p) not in known]
    for p in params:
        s = optimizer.state.get(p, {})
        out += [s[k] for k in sorted(s) if torch.is_tensor(s[k]) and s[k].is_floating_point()]
    return out


def _grouped(tensors: list[torch.Tensor]) -> dict:
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def wrap_step_with_guard(train_step):
    """``train_step`` with the non-finite guard: the same metrics, zeroed on
    a skipped step, plus an int32 ``skipped`` (1: the step was dropped and
    the state is the incoming one)."""

    def guarded_step(state, batch) -> dict:
        before = state_tensors(state)
        groups = _grouped(before)
        with torch.no_grad():
            snaps = [_flat(ts) for ts in groups.values()]
        metrics = train_step(state, batch)
        with torch.no_grad():
            seen = {id(t) for t in before}
            born = [t for t in state_tensors(state) if id(t) not in seen]
            news = [_flat(ts) for ts in groups.values()]
            ok = torch.isfinite(metrics["loss"]).all()
            for t in news + born:
                ok = ok & torch.isfinite(t).all()
            if getattr(state, "layout", None) is not None:
                ok = state.layout.agree_finite(ok)
            for ts, snap, new in zip(groups.values(), snaps, news):
                kept = torch.where(ok, new, snap)
                torch._foreach_copy_(ts, [v.view_as(t) for t, v in
                                          zip(ts, kept.split([t.numel() for t in ts]))])
            for t in born:
                t.copy_(torch.where(ok, t, torch.zeros_like(t)))
            out = {k: torch.where(ok, v, torch.zeros_like(v)) for k, v in metrics.items()}
            out["skipped"] = (~ok).to(torch.int32)
        return out

    return guarded_step


class SkipTracker:
    """Consecutive-skip escalation over the dispatches' on-device
    ``skipped`` values (scalars, or one per step of a block), each read only
    once ``lag`` later values are queued. The streak survives
    :meth:`finish`, so one tracker spans the run's epochs."""

    def __init__(self, max_consecutive: int, lag: int = 32):
        self.max_consecutive = int(max_consecutive)
        self.lag = max(0, int(lag))
        self.consecutive = 0
        self.total = 0
        self.steps = 0
        self._pending: deque = deque()

    def push(self, skipped) -> None:
        """Queue one dispatch's ``skipped``; read the values older than the
        lag (may raise :class:`DivergenceDetected`)."""
        self._pending.append(skipped)
        while len(self._pending) > self.lag:
            self._drain_one()

    def finish(self) -> None:
        """Read everything queued (the epoch's end)."""
        while self._pending:
            self._drain_one()

    def _drain_one(self) -> None:
        from .. import telemetry as tel

        v = self._pending.popleft()
        values = torch.as_tensor(v).reshape(-1).tolist()
        drained_skips = 0
        for s in values:
            self.steps += 1
            if s:
                self.total += 1
                self.consecutive += 1
                drained_skips += 1
            else:
                self.consecutive = 0
        if drained_skips:
            # one journal record per drained dispatch with skips (the JAX
            # guard's): a post-mortem sees which steps the guard dropped
            tel.emit("guard_skip", step=self.steps, skipped=drained_skips,
                     consecutive=self.consecutive, total=self.total)
            tel.counter("guard_skipped_steps_total").inc(drained_skips)
        if 0 < self.max_consecutive <= self.consecutive:
            self._pending.clear()
            tel.emit("divergence", consecutive=self.consecutive, total=self.total,
                     steps=self.steps)
            raise DivergenceDetected(
                f"{self.consecutive} consecutive non-finite training steps were skipped "
                f"({self.total} of {self.steps} steps skipped so far this run) — the run is "
                "diverging")


__all__ = ["DivergenceDetected", "SkipTracker", "TrainingDivergedError", "state_tensors",
           "wrap_step_with_guard"]
