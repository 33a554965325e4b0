"""The SLO autoscaler: the control loop that makes the fleet self-healing.

Counterpart of ``hydragnn_tpu/serve/fleet/autoscaler.py``. The router
survives faults (quarantine, failover); :class:`Autoscaler` acts on its
signals:

* **scale up** when the interactive p99 breaches ``target_p99_ms``, the
  admission backlog exceeds ``max_queue_per_replica`` per active replica,
  or the sheds grow faster than ``shed_tolerance`` per poll, for
  ``up_consecutive`` consecutive polls (hysteresis);
* **scale down** only when the p99 sits under ``down_fraction *
  target_p99_ms`` with an empty backlog and no fresh sheds for
  ``down_consecutive`` polls (calm must prove itself for longer than a
  breach: a spare replica costs money, a missing one costs the SLO);
* **cooldown** after every action, so a fresh replica's effect reaches the
  windows before the loop acts again;
* **drain before retire**: scale-down stops new dispatch to the newest
  replica it owns, waits for its in-flight round-trips, then terminates it.

The decision core (:func:`decide`) is a pure function of
``(AutoscalerConfig, AutoscalerState, Signals, now)``, testable with a
pinned clock. Every decision lands in :attr:`Autoscaler.actions`, and
every action (a decision other than hold, a spawn, a retirement, a failed
poll) in the telemetry journal as an ``autoscale`` record, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import warnings

from ... import telemetry as tel
from .config import AutoscalerConfig

#: decide() return values
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
HOLD = "hold"


@dataclasses.dataclass
class AutoscalerState:
    """Mutable controller state between polls (hysteresis streaks + the
    cooldown clock). Owned by one control loop; never shared."""

    breach_streak: int = 0
    calm_streak: int = 0
    last_action_at: float = float("-inf")
    last_shed: int = 0  # shed counter at the previous poll (rate baseline)


@dataclasses.dataclass
class Signals:
    """One poll's worth of SLO inputs, extracted from router stats."""

    p99_ms: float | None
    queue_depth: int
    shed_total: int
    active_replicas: int

    @staticmethod
    def from_stats(stats: dict) -> "Signals":
        depths = stats.get("queue_depths") or {}
        lat = stats.get("latency_p99_ms") or {}
        return Signals(
            p99_ms=lat.get("interactive"),
            queue_depth=int(sum(depths.values())),
            shed_total=int(stats.get("shed", 0)),
            active_replicas=int(stats.get("active_replicas", 0)),
        )


def decide(cfg: AutoscalerConfig, state: AutoscalerState, sig: Signals,
           now: float) -> tuple[str, str]:
    """One control decision: ``(action, reason)`` with ``action`` one of
    ``scale_up`` / ``scale_down`` / ``hold``. Pure — mutates only
    ``state`` (streaks, shed baseline), reads only its arguments, so tests
    drive it with a fake clock and hand-built signals.

    The caller applies the action and, if it acted, stamps
    ``state.last_action_at = now`` (the cooldown clock)."""
    fresh_shed = max(0, sig.shed_total - state.last_shed)
    state.last_shed = sig.shed_total

    breaches = []
    if sig.p99_ms is not None and sig.p99_ms > cfg.target_p99_ms:
        breaches.append(
            f"p99 {sig.p99_ms:.0f}ms > target {cfg.target_p99_ms:.0f}ms"
        )
    if sig.queue_depth > cfg.max_queue_per_replica * max(
        1, sig.active_replicas
    ):
        breaches.append(
            f"backlog {sig.queue_depth} > "
            f"{cfg.max_queue_per_replica}/replica"
        )
    if fresh_shed > cfg.shed_tolerance:
        breaches.append(f"{fresh_shed} sheds this interval")

    calm = (
        not breaches
        and sig.queue_depth == 0
        and fresh_shed == 0
        and (
            sig.p99_ms is None
            or sig.p99_ms < cfg.down_fraction * cfg.target_p99_ms
        )
    )

    if breaches:
        state.breach_streak += 1
        state.calm_streak = 0
    elif calm:
        state.calm_streak += 1
        state.breach_streak = 0
    else:
        # neither breached nor provably calm (e.g. p99 between the down
        # threshold and the target): both streaks reset — a scale decision
        # needs an unbroken run of evidence
        state.breach_streak = 0
        state.calm_streak = 0

    in_cooldown = now - state.last_action_at < cfg.cooldown_s
    if in_cooldown:
        return HOLD, "cooldown"
    if (
        state.breach_streak >= cfg.up_consecutive
        and sig.active_replicas < cfg.max_replicas
    ):
        return SCALE_UP, "; ".join(breaches)
    if state.breach_streak >= cfg.up_consecutive:
        return HOLD, (
            f"SLO breached ({'; '.join(breaches)}) but at max_replicas "
            f"({cfg.max_replicas})"
        )
    if (
        state.calm_streak >= cfg.down_consecutive
        and sig.active_replicas > cfg.min_replicas
    ):
        return SCALE_DOWN, (
            f"calm for {state.calm_streak} polls "
            f"(p99 {'-' if sig.p99_ms is None else f'{sig.p99_ms:.0f}ms'}, "
            "empty backlog, no sheds)"
        )
    return HOLD, "within targets"


class Autoscaler:
    """The control loop around :func:`decide`.

    ``spawn_fn()`` must boot one replica and return an object the router
    can be attached to — ``(host, port)`` or anything with ``.port`` (a
    ``ReplicaProcess`` from ``spawn_replica``, a ``ReplicaHost``, or a
    test fake); it is also remembered so scale-down can ``terminate()`` it
    if it exposes that. The autoscaler only ever retires replicas IT
    spawned (plus, optionally, ranks handed to ``adopt``) — it never
    retires the seed topology below ``min_replicas``, and never touches
    replicas a rollout owns.
    """

    def __init__(self, router, cfg: "AutoscalerConfig | dict | None" = None,
                 spawn_fn=None):
        self.router = router
        self.cfg = AutoscalerConfig.from_config(cfg).validate()
        self.spawn_fn = spawn_fn
        self.state = AutoscalerState()
        self._lock = threading.Lock()
        # rank -> spawned handle (terminate()-able), for scale-down; only
        # ranks this loop created or adopted are retire candidates
        self._owned: dict = {}  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.actions: list = []  # guarded-by: _lock (decision audit trail)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None and self._thread.is_alive():
            return self
        if self.spawn_fn is None:
            raise ValueError(
                "Autoscaler needs spawn_fn to scale up (a callable booting "
                "one replica)"
            )
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(10.0, 2 * self.cfg.interval_s))
            self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def adopt(self, rank: int, handle=None) -> None:
        """Register an existing replica as retire-eligible (scale-down
        candidates are owned ranks only)."""
        with self._lock:
            self._owned[int(rank)] = handle

    # -- the loop ------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.step()
            except Exception as e:  # a poll failure must not kill the loop
                tel.emit("autoscale", action="error", error=f"{type(e).__name__}: {e}")
                warnings.warn(f"autoscaler poll failed: {type(e).__name__}: {e}")

    def step(self, now: float | None = None) -> tuple[str, str]:
        """One poll + decision + (maybe) action; callable directly by tests
        with a pinned ``now``. Returns ``(action, reason)``."""
        now = time.monotonic() if now is None else now
        sig = Signals.from_stats(self.router.stats())
        action, reason = decide(self.cfg, self.state, sig, now)
        if action == SCALE_UP:
            self._scale_up(reason, sig, now)
        elif action == SCALE_DOWN:
            self._scale_down(reason, sig, now)
        record = {
            "action": action, "reason": reason,
            "p99_ms": sig.p99_ms, "queue_depth": sig.queue_depth,
            "active_replicas": sig.active_replicas,
        }
        with self._lock:
            self.actions.append(record)
        if action != HOLD:
            tel.emit("autoscale", **record)
        return action, reason

    def _scale_up(self, reason: str, sig: Signals, now: float) -> None:
        handle = self.spawn_fn()
        host, port = self._address(handle)
        rank = self.router.attach(host, port)
        with self._lock:
            self._owned[rank] = handle
        self.state.last_action_at = now
        self.state.breach_streak = 0
        tel.emit("autoscale", action="spawned", replica=rank, reason=reason)

    def _scale_down(self, reason: str, sig: Signals, now: float) -> None:
        active = set(self.router.active_ranks())
        with self._lock:
            candidates = sorted(r for r in self._owned if r in active)
        if not candidates:
            return  # nothing owned is active: hold (seed topology stays)
        rank = candidates[-1]  # newest owned replica retires first
        drained = self.router.retire(
            rank, timeout_s=self.cfg.drain_timeout_s
        )
        with self._lock:
            handle = self._owned.pop(rank, None)
        if handle is not None and hasattr(handle, "terminate"):
            handle.terminate()
        self.state.last_action_at = now
        self.state.calm_streak = 0
        tel.emit("autoscale", action="retired", replica=rank, drained=bool(drained),
                 reason=reason)

    @staticmethod
    def _address(handle) -> tuple:
        if isinstance(handle, tuple):
            return handle[0], int(handle[1])
        host = getattr(handle, "host", "127.0.0.1")
        return host, int(handle.port)


__all__ = [
    "Autoscaler",
    "AutoscalerState",
    "HOLD",
    "SCALE_DOWN",
    "SCALE_UP",
    "Signals",
    "decide",
]
