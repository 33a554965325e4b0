"""Fault-tolerant training: the resilience layer.

Counterpart of ``hydragnn_tpu/resilience/``. HydraGNN's users run
multi-day MLIP trainings on DOE schedulers, where preemption, node loss and
diverging bf16 runs are routine. The layer is threaded through the epoch
loop (``train/loop.py``), the checkpoints and the data plane:

* the **non-finite step guard** (``guard.py``) keeps the incoming state of
  a step whose loss or new state is not finite, on the card inside the
  captured step; ``nonfinite_guard: "auto"`` (the default) arms it for
  bf16/fp16 training only, ``HYDRAGNN_NONFINITE_GUARD`` overrides. The
  host reads the skips after the in-flight window and escalates: N skips in
  a row roll back to the last good checkpoint with a cut learning rate
  (written into the captured step's device-side rate: no recapture), M
  rollbacks raise ``TrainingDivergedError``;
* **preemption** (``preempt.py``): SIGTERM/SIGUSR1 ask for a checkpoint at
  the next dispatch boundary; the ranks of a process group agree on it (a
  gloo poll on the host about every ``POLL_S`` seconds, so the card's
  stream is never waited on);
* **exact mid-epoch resume**: the preemption checkpoint's sidecar holds the
  epoch, the raw batches done, the shuffle seed, K and the group width; a
  resumed run trains exactly the batches not yet seen, so a run killed at
  step k and resumed in a fresh process ends bit-equal to an uninterrupted
  fp32 run;
* the **watchdog** (``watchdog.py``) puts deadlines around the loop's
  blocking reads and the store's replica round-trips;
* **fault injection** (``chaos.py``, ``HYDRAGNN_FAULT_PLAN``), the
  **elastic controller** (``elastic.py``: the survivors of a lost rank go on
  in a smaller process group, in process) and the seeded **campaign**
  (``campaign.py``).

The guard wraps any ``(state, batch) -> metrics`` step, so the one-device,
data-parallel, FSDP, tensor-parallel, pipelined, halo and edge-sharded
steps all pass through it.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext

import torch

from .chaos import FaultPlan
from .guard import (DivergenceDetected, SkipTracker, TrainingDivergedError, state_tensors,
                    wrap_step_with_guard)
from .preempt import PreemptionHandler
from .watchdog import Watchdog


@dataclasses.dataclass
class Resilience:
    """A run's resilience context: its configuration and the live fault
    machinery, built once (:meth:`from_config`) and threaded through
    ``train_validate_test``; also the channel by which the loop tells
    ``run_training`` that it stopped preempted (no final save then)."""

    guard_enabled: bool = True
    max_consecutive_skips: int = 25
    max_rollbacks: int = 2
    rollback_lr_factor: float = 0.5
    checkpoint_on_preempt: bool = True
    checkpoint_every_epoch: bool = False
    watchdog_timeout: float = 0.0
    elastic: bool = False
    max_recoveries: int = 4
    watchdog_dispatch_s: float = 0.0
    # under a process group the ranks agree on a stop request (a gloo
    # all-reduce on the host, ~1.5 ms on four H100s' host, PERF.md) at an
    # epoch's first dispatch, at its end, and between about every POLL_S
    # seconds; poll_every 1 (an elastic run, a fault plan): every dispatch
    POLL_S = 1.0
    poll_every: int = 0

    preempt: PreemptionHandler | None = None
    chaos: FaultPlan | None = None
    watchdog: Watchdog | None = None
    dispatch_watchdog: Watchdog | None = None
    tracker: SkipTracker | None = None
    controller: object | None = None

    # the Training.resilience keys whose defaults are these field defaults
    CONFIG_KEYS = ("max_consecutive_skips", "max_rollbacks", "rollback_lr_factor",
                   "checkpoint_on_preempt", "checkpoint_every_epoch", "watchdog_timeout",
                   "elastic", "max_recoveries", "watchdog_dispatch_s")

    # live state, written by the loop
    current_epoch: int = 0
    interrupted: bool = False
    epoch_raw_done: int = 0
    preempted: bool = False
    skipped_total: int = 0
    rollbacks: int = 0
    hung_dispatches: int = 0
    resume_mode: str | None = None
    resume_reason: str | None = None
    _agree: object = None  # (default group, its gloo twin)
    # the time-based poll's schedule: the next poll's dispatch, the ranks'
    # agreed dispatches per POLL_S, and the last poll's (dispatch, time)
    _next_poll: int = 0
    _poll_stride: int = 8
    _last_poll: tuple = (0, 0.0)

    @staticmethod
    def from_config(training_cfg: dict, device="cpu") -> "Resilience":
        """From the ``Training.resilience`` block (absent keys take the field
        defaults). ``nonfinite_guard``: True, False or ``"auto"`` (arm the
        guard when ``Training.precision`` resolves to a 2-byte dtype on
        ``device``); ``HYDRAGNN_NONFINITE_GUARD`` overrides it,
        ``HYDRAGNN_ELASTIC`` the elastic switch and
        ``HYDRAGNN_WATCHDOG_DISPATCH_S`` the dispatch deadline;
        ``HYDRAGNN_FAULT_PLAN`` arms the chaos plan."""
        from ..train.step import resolve_precision
        from ..utils import flags

        cfg = dict(training_cfg.get("resilience") or {})
        guard = cfg.get("nonfinite_guard", "auto")
        if guard == "auto" or guard is None:
            dtype = resolve_precision(str(training_cfg.get("precision", "fp32")), device)
            guard = torch.finfo(dtype).bits < 32
        guard = bool(guard)
        env_guard = flags.get(flags.NONFINITE_GUARD)
        if env_guard is not None:
            guard = bool(env_guard)
        d = config_defaults()
        timeout = float(cfg.get("watchdog_timeout", d["watchdog_timeout"]) or 0.0)
        elastic = bool(cfg.get("elastic", d["elastic"]))
        env_elastic = flags.get(flags.ELASTIC)
        if env_elastic is not None:
            elastic = bool(env_elastic)
        dispatch_s = float(flags.get(flags.WATCHDOG_DISPATCH_S, default=float(
            cfg.get("watchdog_dispatch_s", d["watchdog_dispatch_s"]) or 0.0)) or 0.0)
        res = Resilience(
            guard_enabled=guard,
            max_consecutive_skips=int(cfg.get("max_consecutive_skips",
                                              d["max_consecutive_skips"])),
            max_rollbacks=int(cfg.get("max_rollbacks", d["max_rollbacks"])),
            rollback_lr_factor=float(cfg.get("rollback_lr_factor", d["rollback_lr_factor"])),
            checkpoint_on_preempt=bool(cfg.get("checkpoint_on_preempt",
                                               d["checkpoint_on_preempt"])),
            checkpoint_every_epoch=bool(cfg.get("checkpoint_every_epoch",
                                                d["checkpoint_every_epoch"])),
            watchdog_timeout=timeout, elastic=elastic,
            max_recoveries=int(cfg.get("max_recoveries", d["max_recoveries"])),
            watchdog_dispatch_s=dispatch_s, chaos=FaultPlan.from_env(),
            watchdog=Watchdog(timeout) if timeout > 0 else None,
            dispatch_watchdog=Watchdog(dispatch_s) if dispatch_s > 0 else None,
        )
        if res.checkpoint_on_preempt:
            res.preempt = PreemptionHandler()
        if res.elastic or res.chaos is not None:
            res.poll_every = 1
        return res

    # -- loop hooks ----------------------------------------------------------
    def install(self) -> None:
        if self.preempt is not None:
            self.preempt.install()

    def uninstall(self) -> None:
        if self.preempt is not None:
            self.preempt.uninstall()

    def preempt_requested(self) -> bool:
        """This process's stop request (a signal, or the controller's)."""
        return self.preempt is not None and self.preempt.requested

    def _agree_group(self):
        """A gloo group over the default group's ranks (formed once per
        default group, on every rank alike): the stop poll runs on the host,
        never on the card's stream."""
        import torch.distributed as dist

        world = dist.group.WORLD
        if self._agree is None or self._agree[0] is not world:
            self._agree = (world, dist.new_group(backend="gloo"))
        return self._agree[1]

    def bind_group(self) -> None:
        """Form the stop poll's group now (every rank of a process group
        calls this at the same point), if a group is live."""
        from ..parallel.comm import world_of

        if world_of() > 1:
            self._agree_group()

    def agree(self, flag: bool, value: float = 0.0) -> tuple[bool, float]:
        """``flag`` of any rank and the largest ``value``, the same on every
        rank of a process group (every rank calls this at the same
        point)."""
        import torch.distributed as dist

        from ..parallel.comm import world_of

        if world_of() <= 1:
            return bool(flag), float(value)
        t = torch.tensor([1.0 if flag else 0.0, float(value)], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._agree_group())
        return bool(t[0].item()), float(t[1].item())

    def stop_requested(self, dispatch: int | None = None) -> bool:
        """Whether the run stops at this boundary. Alone: this process's
        request. Under a process group: any rank's request, agreed by all
        at an epoch's first dispatch and its end (``dispatch=None``) and in
        between at the dispatches the last poll scheduled (every one under
        ``poll_every`` 1), the same answer on every rank. Each poll also
        agrees on the slowest rank's seconds per dispatch since the last,
        and schedules the next ``POLL_S`` of them ahead."""
        import time

        from ..parallel.comm import world_of

        if world_of() <= 1:
            return self.preempt_requested()
        if dispatch is not None and dispatch > 0 and self.poll_every != 1 \
                and dispatch < self._next_poll:
            return False
        now = time.perf_counter()
        last, then = self._last_poll
        pace = (now - then) / (dispatch - last) if dispatch and dispatch > last else 0.0
        stop, pace = self.agree(self.preempt_requested(), pace)
        if pace > 0.0:
            self._poll_stride = max(1, min(4096, int(self.POLL_S / pace)))
        if dispatch is not None:
            self._next_poll = dispatch + self._poll_stride
            self._last_poll = (dispatch, now)
        if stop:
            self.request_checkpoint()
        return stop

    def request_checkpoint(self) -> None:
        """A programmatic drain request (the elastic controller's channel),
        as a delivered SIGTERM."""
        if self.preempt is None:
            self.preempt = PreemptionHandler()  # event only; never installed
        self.preempt.request()

    def note_hung_dispatch(self) -> None:
        """A dispatch-watchdog expiry: counted, and under an elastic
        controller a recoverable fault. Called from the monitor thread."""
        self.hung_dispatches += 1
        if self.controller is not None:
            from .elastic import Fault

            self.controller.signal(Fault(kind="hung_dispatch", detail="dispatch watchdog"))

    def reset_for_resume(self) -> None:
        """Clear the drain state before the elastic driver re-enters the
        loop (else the resumed segment would drain again at once)."""
        if self.preempt is not None:
            self.preempt.clear()
        self.preempted = False
        self.interrupted = False
        self.resume_mode = None
        self.resume_reason = None

    def new_tracker(self, lag: int) -> SkipTracker | None:
        """The run's one skip-streak tracker (it spans epochs: a divergence
        that skips every step of short epochs still escalates), or None
        when the guard or its escalation is off."""
        if not self.guard_enabled or self.max_consecutive_skips <= 0:
            return None
        if self.tracker is None:
            self.tracker = SkipTracker(self.max_consecutive_skips, lag=lag)
        else:
            self.tracker.lag = max(0, int(lag))
        return self.tracker

    def reset_streak(self) -> None:
        """Forget the streak (a rollback restored a good state)."""
        if self.tracker is not None:
            self.tracker.consecutive = 0

    def watchdog_guard(self, what: str):
        return nullcontext() if self.watchdog is None else self.watchdog.guard(what)


def config_defaults() -> dict:
    """``{key: default}`` of the ``Training.resilience`` block, read off the
    :class:`Resilience` fields (``config/schema.py`` fills the block from
    it)."""
    fields = {f.name: f.default for f in dataclasses.fields(Resilience)}
    return {k: fields[k] for k in Resilience.CONFIG_KEYS}


from .elastic import (ElasticController, ElasticRecoveryError, Fault,  # noqa: E402
                      train_elastic)

__all__ = [
    "DivergenceDetected",
    "ElasticController",
    "ElasticRecoveryError",
    "Fault",
    "FaultPlan",
    "PreemptionHandler",
    "Resilience",
    "SkipTracker",
    "TrainingDivergedError",
    "Watchdog",
    "config_defaults",
    "state_tensors",
    "train_elastic",
    "wrap_step_with_guard",
]
