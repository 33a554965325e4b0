"""In-process elastic recovery: the survivors of a lost rank go on.

Counterpart of ``hydragnn_tpu/resilience/elastic.py``, for one process per
GPU. The JAX package drops lost devices from one process's mesh; the port's
ranks are processes, so a recovery re-forms the process group::

    running --fault--> draining --checkpoint--> re-mesh --> resumed
                                            \\--policy--> restart-fallback

* **draining**: a recoverable fault (chaos ``device_loss``/``mesh_shrink``,
  SIGTERM, a hung-dispatch expiry) asks the loop to stop at a dispatch
  boundary. Every rank of the group stops at the same one: the chaos plan
  fires on every rank at the same coordinates, and the ranks agree on any
  stop request (``Resilience.stop_requested``). The loop finishes the
  dispatch, waits for the card, and the ranks save the mid-epoch checkpoint
  together; its sidecar holds the loader's position on the logical update
  grid (the old world's group width).
* **re-mesh**: the controller drops the lost ranks; every rank leaves the
  group after a barrier (no collective is in flight then, so NCCL cannot
  hang on a rank that is gone), the lost ranks return (their process
  exits), and the survivors form a group of the survivors' count over the
  same rendezvous store under a fresh prefix (``parallel/distributed.py::
  reform_group``), in process.
* **resumed**: the survivors reload the checkpoint into their state,
  re-place it on the new group and re-enter the loop with the sidecar: the
  interrupted epoch finishes on the saved grid (each survivor takes its
  slots of every old group and accumulates their gradients, eager), later
  epochs on the survivors' own grid. Zero samples are lost or trained
  twice; the state is allclose to an uninterrupted run at the learning
  rate's scale (the sums associate otherwise). The checkpoint holds one
  dropout generator per old rank; a group of another size continues from
  rank 0's on every survivor.
* **restart-fallback**: pipeline, tensor-parallel, halo and edge-sharded
  layouts bake the world into their partitioning, a one-rank run has no
  group to re-form, and the rendezvous store lives in rank 0: their
  recovery returns the preempted state with the mid-epoch checkpoint on
  disk as the resume point of a restarted job, a recorded policy decision.

Every recovery is journalled under one ``recovery_id`` (set in the journal
context when the fault is signalled, cleared when the run is healthy): the
``fault``, each ``recovery_phase`` and the closing ``recovery`` record,
which ``python -m hydragnn_tpu_torch.telemetry`` reconstructs phase by
phase.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
import warnings

from .. import telemetry as tel


class ElasticRecoveryError(RuntimeError):
    """No survivor is left, or the recovery budget is spent."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One recoverable fault. ``device`` is an original rank (stable
    across recoveries); ``to`` is ``mesh_shrink``'s survivor count."""

    kind: str  # device_loss | mesh_shrink | sigterm | hung_dispatch | external
    device: int | None = None
    count: int = 1
    to: int | None = None
    detail: str = ""
    t_signal: float = 0.0

    KINDS = ("device_loss", "mesh_shrink", "sigterm", "hung_dispatch", "external")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {self.KINDS}")


class ElasticController:
    """Survivor bookkeeping over the original ranks, fault intake from any
    thread (the watchdog's monitor, signal context through the attached
    ``Resilience``, the chaos hooks), and the log of states and recoveries.
    It has no thread of its own: the drain happens on the training thread
    at the loop's boundary poll."""

    STATES = ("running", "draining", "re-mesh", "resumed", "restart_fallback", "preempted",
              "done", "failed", "lost")

    def __init__(self, ranks=None, max_recoveries: int = 4, recovery_budget_s: float = 120.0,
                 recover_on_preempt: bool = True):
        self._lock = threading.Lock()
        self._all: list | None = list(ranks) if ranks is not None else None  # guarded-by: _lock
        self._lost: set[int] = set()  # guarded-by: _lock
        self._pending: list[Fault] = []  # guarded-by: _lock
        self.state = "running"  # guarded-by: _lock
        self.events: list[tuple] = []  # guarded-by: _lock
        # the journal's correlation id of the recovery under way
        self.recovery_id: str | None = None  # guarded-by: _lock
        self.recoveries = 0  # training thread only
        self.recovery_log: list[dict] = []  # training thread only
        self.max_recoveries = int(max_recoveries)
        self.recovery_budget_s = float(recovery_budget_s)
        self.recover_on_preempt = bool(recover_on_preempt)
        self.resilience = None

    def bind_ranks(self, ranks) -> None:
        """Pin the original ranks (the first bind wins, so a plan's indices
        name the same rank whatever was lost before)."""
        with self._lock:
            if self._all is None and ranks is not None:
                self._all = list(ranks)

    def attach(self, resilience) -> None:
        """Link with the run's ``Resilience``: the controller drains through
        its preemption channel, and its dispatch watchdog reports here."""
        self.resilience = resilience
        resilience.controller = self
        if resilience.preempt is None:
            from .preempt import PreemptionHandler

            resilience.preempt = PreemptionHandler()

    def signal(self, fault: Fault) -> None:
        """Record a fault and ask the loop to drain; safe from any thread."""
        if fault.t_signal == 0.0:
            fault = dataclasses.replace(fault, t_signal=time.monotonic())
        with self._lock:
            self._pending.append(fault)
            self.state = "draining"
            self.events.append((fault.t_signal, "fault", fault.kind))
            if self.recovery_id is None:
                self.recovery_id = f"rec{self.recoveries + 1}"
            # set under the same lock as the id: a concurrent
            # set_state("running") cannot wipe a new recovery's id. Every
            # record from here through the resume carries it
            tel.set_context(recovery_id=self.recovery_id)
        tel.emit("fault", fault=fault.kind, device=fault.device, count=fault.count,
                 to=fault.to, detail=fault.detail or None)
        tel.emit("recovery_phase", phase="draining", detail=fault.kind)
        tel.counter("elastic_faults_total", kind=fault.kind).inc()
        if self.resilience is not None:
            self.resilience.request_checkpoint()

    def take_pending(self) -> list[Fault]:
        with self._lock:
            out, self._pending = self._pending, []
            return out

    def set_state(self, state: str, detail: str = "") -> None:
        assert state in self.STATES, state
        with self._lock:
            self.state = state
            self.events.append((time.monotonic(), state, detail))
            if state == "running":
                # healthy again: later records belong to no recovery
                self.recovery_id = None
                tel.set_context(recovery_id=None)
        tel.emit("recovery_phase", phase=state, detail=detail or None)

    def survivors(self) -> list:
        with self._lock:
            if self._all is None:
                return []
            return [d for i, d in enumerate(self._all) if i not in self._lost]

    def lost_indices(self) -> tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._lost))

    def apply(self, fault: Fault) -> str:
        """A fault's effect on the survivors; returns its description.
        Raises :class:`ElasticRecoveryError` when none would survive."""
        with self._lock:
            n_all = len(self._all or ())
            if fault.kind == "device_loss":
                start = fault.device if fault.device is not None else n_all - 1
                victims, i = [], start
                # down from the named rank over the ranks still alive
                while len(victims) < max(1, fault.count) and i >= 0:
                    if i < n_all and i not in self._lost:
                        victims.append(i)
                    i -= 1
                if not victims:
                    return f"device_loss: rank {fault.device} already lost (inert)"
                self._lost.update(victims)
                desc = f"device_loss: lost original ranks {sorted(victims)}"
            elif fault.kind == "mesh_shrink":
                target = max(1, int(fault.to or 1))
                alive = [i for i in range(n_all) if i not in self._lost]
                if len(alive) > target:
                    self._lost.update(alive[target:])
                desc = f"mesh_shrink: target {target} survivors"
            else:
                return f"{fault.kind}: no topology change"
            if n_all and len(self._lost) >= n_all:
                self.state = "failed"
                raise ElasticRecoveryError(f"{desc} leaves no survivor: the checkpoint on disk "
                                           "is the resume point of a replacement job")
            return desc

    def apply_nested(self, event: dict):
        """A ``double_fault`` payload during a recovery: a topology fault
        folds into the re-mesh under way; a nested ``sigterm`` returns True
        (the driver re-arms the drain after ``reset_for_resume``)."""
        kind = str(event.get("fault", "device_loss"))
        if kind == "sigterm":
            with self._lock:
                self.events.append((time.monotonic(), "nested_fault", "sigterm"))
            return True
        desc = self.apply(Fault(kind=kind, device=event.get("device"),
                                count=int(event.get("count", 1)), to=event.get("to"),
                                detail="double_fault"))
        with self._lock:
            self.events.append((time.monotonic(), "nested_fault", desc))
        return desc

    def plan_remesh(self, route: str) -> tuple[str, str]:
        """``(mode, reason)`` for the run's ``route`` (``"data"``,
        ``"tensor"``, ``"pipeline"``, ``"halo"``, ``"edge"``, ``"single"``):
        ``"resume"`` (no rank lost), ``"remesh"`` (the survivors form a
        smaller data-parallel group) or ``"restart_fallback"``."""
        lost = self.lost_indices()
        if not lost:
            return "resume", "topology unchanged"
        reasons = {
            "single": "a one-rank run has no group to re-form from survivors",
            "pipeline": "the pipeline's stage count is baked into the model partitioning",
            "tensor": "tensor-parallel feature sharding pins the model group's width",
            "halo": "the halo partition count is baked into the exchange plan",
            "edge": "edge-sharded placement has no resharded equivalent",
        }
        if route in reasons:
            return "restart_fallback", reasons[route]
        if 0 in lost:
            return "restart_fallback", "rank 0 hosts the rendezvous store the survivors re-form on"
        return "remesh", f"data-parallel group re-formed from {len(self.survivors())} survivor(s)"

    def note_recovery(self, faults, mode: str, recovery_ms: float, meta: dict) -> None:
        over = recovery_ms > 1e3 * self.recovery_budget_s
        entry = {
            "faults": [f.kind for f in faults], "mode": mode, "recovery_ms": float(recovery_ms),
            "over_budget": over, "lost_indices": list(self.lost_indices()),
            "resumed_epoch": meta.get("epoch"), "raw_batches_done": meta.get("raw_batches_done"),
            "logical_n_dev": meta.get("n_dev")}
        self.recovery_log.append(entry)
        # the same fields as a journal record, under the recovery's id
        tel.emit("recovery", **entry)
        tel.counter("elastic_recoveries_total", mode=mode).inc()
        tel.gauge("elastic_recovery_ms").set(float(recovery_ms))
        self.recoveries += 1
        if over:
            warnings.warn(f"elastic recovery #{self.recoveries} took {recovery_ms:.0f} ms, over "
                          f"the controller's {self.recovery_budget_s:.0f} s budget")


_REG_LOCK = threading.Lock()
_ACTIVE: list[ElasticController] = []  # guarded-by: _REG_LOCK


def active_controller() -> ElasticController | None:
    """The innermost live controller (chaos events go there), or None."""
    with _REG_LOCK:
        return _ACTIVE[-1] if _ACTIVE else None


def deliver_fault(kind: str, **kw) -> bool:
    """The chaos entry point: signal the active controller, or note and
    skip when no elastic run is live (the event is inert then)."""
    ctl = active_controller()
    if ctl is None:
        print(f"[chaos] {kind} fault with no active ElasticController (HYDRAGNN_ELASTIC off or "
              "a direct train_validate_test run); fault skipped", file=sys.stderr)
        return False
    ctl.signal(Fault(kind=kind, device=kw.get("device"), count=int(kw.get("count", 1)),
                     to=kw.get("to"), detail=kw.get("detail", "chaos")))
    return True


def train_elastic(run_segment, reform, resilience, controller: ElasticController | None = None,
                  route: str = "data", world: int = 1, log=print):
    """The loop inside the recovery driver. ``run_segment(resume_meta) ->
    state`` runs ``train_validate_test`` on the current group;
    ``reform(survivors, generation, mode) -> meta | None`` restores the
    mid-epoch checkpoint into the state and returns its metadata: in mode
    ``"resume"`` (no rank lost) in place, in mode ``"remesh"`` after leaving
    the group and, on a survivor, forming the new one (None on a rank that
    left). Returns
    ``(state, controller)``; ``controller.state`` ends ``"done"``,
    ``"lost"`` (this rank left the run), ``"restart_fallback"`` or
    ``"preempted"``."""
    res = resilience
    ctl = controller if controller is not None else ElasticController(
        max_recoveries=res.max_recoveries)
    ctl.bind_ranks(range(world))
    ctl.attach(res)
    with _REG_LOCK:
        _ACTIVE.append(ctl)
    resume_meta = None
    try:
        while True:
            ctl.set_state("running")
            state = run_segment(resume_meta)
            if not res.preempted:
                ctl.set_state("done")
                return state, ctl
            faults = ctl.take_pending()
            if not faults:
                if not ctl.recover_on_preempt:
                    ctl.set_state("preempted", "external preemption; stopping")
                    return state, ctl
                faults = [Fault(kind="external", t_signal=time.monotonic())]
            if ctl.recoveries >= ctl.max_recoveries:
                ctl.set_state("failed", "recovery budget exhausted")
                raise ElasticRecoveryError(
                    f"{ctl.recoveries} in-process recoveries already spent (max_recoveries="
                    f"{ctl.max_recoveries}) and another fault arrived; the mid-epoch "
                    "checkpoint on disk is the resume point")
            t0 = min(f.t_signal or time.monotonic() for f in faults)
            ctl.set_state("re-mesh")
            for f in faults:
                log(f"elastic recovery: {ctl.apply(f)}")
            redrain = False
            if res.chaos is not None:
                for nested in res.chaos.on_recovery(ctl.recoveries + 1):
                    desc = ctl.apply_nested(nested)
                    if desc is True:
                        redrain, desc = True, "nested sigterm: the resumed segment re-drains"
                    log(f"elastic recovery (double fault): {desc}")
            mode, reason = ctl.plan_remesh(route)
            if mode == "restart_fallback":
                ctl.set_state("restart_fallback", reason)
                log(f"elastic recovery: no in-process re-mesh ({reason}); the mid-epoch "
                    "checkpoint is the resume point of a restarted job")
                return state, ctl
            meta = reform(ctl.survivors(), ctl.recoveries + 1, mode)
            if meta is None:
                ctl.set_state("lost", "this rank left the group")
                return state, ctl
            resume_meta = meta if meta.get("mid_epoch") else None
            res.reset_for_resume()
            if redrain:
                res.request_checkpoint()
            recovery_ms = 1e3 * (time.monotonic() - t0)
            ctl.note_recovery(faults, mode, recovery_ms, meta)
            ctl.set_state("resumed", f"{mode} in {recovery_ms:.0f} ms")
            log(f"elastic recovery #{ctl.recoveries}: {mode} in {recovery_ms:.0f} ms; resuming "
                f"epoch {meta.get('epoch')} at raw batch {meta.get('raw_batches_done', 0)}")
    finally:
        with _REG_LOCK:
            if ctl in _ACTIVE:
                _ACTIVE.remove(ctl)


__all__ = ["ElasticController", "ElasticRecoveryError", "Fault", "active_controller",
           "deliver_fault", "train_elastic"]
