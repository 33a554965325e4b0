"""Seeded multi-fault chaos campaigns and their invariants.

Counterpart of the training half of ``hydragnn_tpu/resilience/campaign.py``
(the serving fleet's half comes with a later slice, ROADMAP item 10). One fault proves one recovery path; production failures are
compositions: a NaN blow-up before a preemption, a rank lost while a peer
is quarantined, a second fault during a recovery. A seeded scheduler
composes the chaos vocabulary into ``HYDRAGNN_FAULT_PLAN`` schedules, and
:func:`check_invariants` holds every executed schedule to four invariants:

1. **zero lost samples**: the faulted run takes exactly the reference
   run's optimizer updates (its step count);
2. **state agreement**: bit-exact against the reference where the
   topology never changed, allclose at the learning rate's scale after a
   shrink (the survivors' sums associate otherwise, and one Adam update
   turns any difference into an O(lr) move);
3. **no leaked threads**: no non-daemon thread outlives the run;
4. **bounded recovery**: every recovery within the budget.

The reference run replays the events that change the training itself
(``nan_batch``: both runs skip the same poisoned update) and none of the
recovery events. Fault coordinates are (epoch, dispatch within the
epoch), and a resumed tail numbers its dispatches from 0 again, so the
perturbing events land in epochs before the first recovery event and the
recovery events in the last epoch; ``hang``, ``dead_shard`` and
``slow_peer`` change nothing and land anywhere.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

PERTURBING_FAULTS = ("nan_batch",)
RECOVERY_FAULTS = ("sigterm", "device_loss", "mesh_shrink", "double_fault")
BENIGN_FAULTS = ("hang", "dead_shard", "slow_peer")
# double_fault rides along with a recovery fault and is drawn apart
DEFAULT_VOCAB = PERTURBING_FAULTS + BENIGN_FAULTS + ("sigterm", "device_loss", "mesh_shrink")


def split_plan(events: list[dict]) -> tuple[list[dict], list[dict]]:
    """``(reference events, all events)``: the reference replays only the
    perturbing ones."""
    return [e for e in events if e.get("fault") in PERTURBING_FAULTS], list(events)


def random_fault_schedule(seed: int, *, epochs: int, dispatches: int, n_devices: int = 1,
                          kinds=DEFAULT_VOCAB, max_faults: int = 3,
                          n_peers: int = 0) -> list[dict]:
    """One seeded schedule (a ``HYDRAGNN_FAULT_PLAN`` event list), placed
    as the module says: at most ``n_devices - 1`` ranks ever lost, and
    ``double_fault`` only beside a recovery fault. Deterministic per
    ``(seed, kwargs)``; the JAX package's scheduler draw for draw."""
    rng = np.random.default_rng(seed)
    kinds = list(kinds)
    if n_devices <= 1:
        kinds = [k for k in kinds if k not in ("device_loss", "mesh_shrink")]
    if n_peers <= 0:
        kinds = [k for k in kinds if k not in ("dead_shard", "slow_peer")]
    if epochs < 2:
        kinds = [k for k in kinds if k not in PERTURBING_FAULTS]
    kinds = [k for k in kinds if k != "double_fault"]
    if not kinds:
        raise ValueError("fault vocabulary is empty under the constraints")
    n_faults = int(rng.integers(1, max(2, max_faults + 1)))
    final = epochs - 1
    loss_budget = max(0, n_devices - 1)
    events: list[dict] = []
    for _ in range(n_faults):
        kind = kinds[int(rng.integers(len(kinds)))]
        if kind in ("device_loss", "mesh_shrink") and loss_budget <= 0:
            kind = "sigterm"
        ev: dict = {"fault": kind}
        if kind in PERTURBING_FAULTS:
            ev["epoch"] = int(rng.integers(0, max(1, final)))
            ev["dispatch"] = int(rng.integers(0, dispatches))
        elif kind == "device_loss":
            ev["epoch"] = final
            ev["dispatch"] = int(rng.integers(0, dispatches))
            ev["device"] = int(rng.integers(0, n_devices))
            loss_budget -= 1
        elif kind == "mesh_shrink":
            target = int(rng.integers(n_devices - loss_budget, n_devices))
            ev["epoch"] = final
            ev["dispatch"] = int(rng.integers(0, dispatches))
            ev["to"] = max(1, target)
            loss_budget = max(0, target - 1)
        elif kind == "sigterm":
            ev["epoch"] = final
            ev["dispatch"] = int(rng.integers(0, dispatches))
        elif kind == "hang":
            ev["epoch"] = int(rng.integers(0, epochs))
            ev["dispatch"] = int(rng.integers(0, dispatches))
            ev["seconds"] = round(float(rng.uniform(0.05, 0.2)), 3)
        elif kind in ("dead_shard", "slow_peer"):
            ev["epoch"] = int(rng.integers(0, epochs))
            ev["dispatch"] = int(rng.integers(0, dispatches))
            ev["peer"] = int(rng.integers(0, n_peers))
            if kind == "slow_peer":
                ev["seconds"] = round(float(rng.uniform(0.3, 0.8)), 3)
        events.append(ev)
    has_recovery = any(e["fault"] in RECOVERY_FAULTS for e in events)
    if (has_recovery and n_devices > 1 and loss_budget > 0 and "device_loss" in kinds
            and rng.random() < 0.5):
        events.append({"fault": "double_fault", "inner": {"fault": "device_loss"}})
    events.sort(key=lambda e: (e.get("epoch", epochs), e.get("dispatch") or 0))
    return events


@dataclasses.dataclass
class ScheduleOutcome:
    """What the invariants read of one executed schedule: the reference's
    and the faulted run's final states (``{name: array}``, parameters,
    running statistics and optimizer state) and step counts, the
    controller, the learning rate (the shrink tolerance's scale), the
    updates taken after the first topology change, and the non-daemon
    thread counts before and after."""

    seed: int
    events: list
    ref_state: dict
    state: dict
    ref_step: int
    step: int
    controller: object
    lr: float
    mesh_changed: bool
    approx_updates: int = 1
    threads_before: int = 0
    threads_after: int = 0
    recovery_budget_ms: float = 60_000.0


def nondaemon_thread_count() -> int:
    return sum(1 for t in threading.enumerate() if not t.daemon)


def check_invariants(out: ScheduleOutcome) -> list[str]:
    """The campaign's gate: the violations (empty: the schedule degraded
    gracefully)."""
    violations: list[str] = []
    if sorted(out.ref_state) != sorted(out.state):
        return [f"seed {out.seed}: state structure diverged"]
    if out.ref_step != out.step:
        violations.append(f"seed {out.seed}: lost or duplicated updates — step {out.step} vs "
                          f"reference {out.ref_step}")
    atol = out.lr * max(1, int(out.approx_updates))
    for name in sorted(out.ref_state):
        x, y = np.asarray(out.ref_state[name]), np.asarray(out.state[name])
        if x.shape != y.shape or x.dtype != y.dtype:
            violations.append(f"seed {out.seed}: {name} shape/dtype diverged")
            break
        if not out.mesh_changed:
            if not np.array_equal(x, y):
                violations.append(f"seed {out.seed}: {name} not bit-exact though the topology "
                                  "never changed")
                break
        elif np.issubdtype(x.dtype, np.floating):
            if not np.allclose(x, y, rtol=2e-2, atol=atol):
                violations.append(f"seed {out.seed}: {name} off by "
                                  f"{float(np.max(np.abs(x - y))):.2e} (> lr-scale tolerance "
                                  f"{atol:.2e} after a shrink)")
                break
        elif not np.array_equal(x, y):
            violations.append(f"seed {out.seed}: non-float {name} diverged")
            break
    ctl = out.controller
    if ctl is not None:
        for rec in getattr(ctl, "recovery_log", ()):
            if rec["recovery_ms"] > out.recovery_budget_ms:
                violations.append(f"seed {out.seed}: recovery took {rec['recovery_ms']:.0f} ms "
                                  f"(> {out.recovery_budget_ms:.0f} ms budget)")
        if getattr(ctl, "state", None) not in ("done", "running"):
            violations.append(f"seed {out.seed}: controller ended in state "
                              f"{getattr(ctl, 'state', None)!r}, not 'done'")
    if out.threads_after > out.threads_before:
        violations.append(f"seed {out.seed}: {out.threads_after - out.threads_before} "
                          "non-daemon thread(s) leaked")
    return violations


def run_campaign(seeds, run_schedule, **schedule_kw) -> dict:
    """One schedule per seed, run by ``run_schedule(seed, events) ->
    ScheduleOutcome`` (the caller owns the model, loaders and driver), each
    held to :func:`check_invariants`. ``report["passed"]``: no violation."""
    report: dict = {"schedules": [], "violations": []}
    for seed in seeds:
        events = random_fault_schedule(int(seed), **schedule_kw)
        outcome = run_schedule(int(seed), [dict(e) for e in events])
        violations = check_invariants(outcome)
        report["schedules"].append({
            "seed": int(seed), "events": events,
            "recoveries": getattr(outcome.controller, "recoveries", 0),
            "mesh_changed": outcome.mesh_changed, "violations": violations})
        report["violations"].extend(violations)
    report["n_schedules"] = len(report["schedules"])
    report["passed"] = not report["violations"]
    return report


__all__ = ["BENIGN_FAULTS", "DEFAULT_VOCAB", "PERTURBING_FAULTS", "RECOVERY_FAULTS",
           "ScheduleOutcome", "check_invariants", "nondaemon_thread_count",
           "random_fault_schedule", "run_campaign", "split_plan"]
