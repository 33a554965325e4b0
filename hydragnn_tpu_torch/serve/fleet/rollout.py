"""Zero-downtime blue/green rollout for the serving fleet.

Counterpart of ``hydragnn_tpu/serve/fleet/rollout.py``.
:func:`blue_green_rollout`:

1. the caller boots the green generation beside the live (blue) one; the
   router keeps serving from blue;
2. the **bit-identity canary** (:func:`run_canary`): every green replica is
   probed directly over the wire (never through the router, so canary
   traffic touches neither the answer cache nor the latency windows) on a
   pinned probe batch, and its answers are compared bit for bit with the
   live set's on the same samples; any difference refuses the rollout with
   :class:`CanaryMismatchError` and leaves the live set untouched;
3. **cutover**: green attaches, then every blue rank drains (no new
   dispatch, in-flight round-trips finish) and retires. A request admitted
   during the swap is served once, by whichever generation dispatch gives
   it to, which the canary's proof makes safe.

Every stage (begin, each green replica's canary verdict, cutover,
complete) lands in the telemetry journal as a ``rollout`` record, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np

from ... import telemetry as tel
from ...utils import wire
from ...utils.retry import RetryPolicy
from .config import RolloutConfig

_ONE_ATTEMPT = RetryPolicy(attempts=1)


class CanaryMismatchError(RuntimeError):
    """A green replica's served answer differed from the live set's on a
    pinned probe — the rollout is refused and the live set untouched.
    Bit-identity is the contract that makes mid-cutover dual-serving safe;
    a generation that cannot meet it must not join the fleet."""


def _probe_predict(rt, host: str, port: int, model: str, sample,
                   what: str) -> list:
    """One direct-wire predict round-trip (the replica's normal serving
    path — micro-batcher, warm executable — just not via the router)."""
    z = rt.round_trip(
        (host, port), host, port, policy=_ONE_ATTEMPT, what=what,
        predict=np.asarray(1, np.int64),
        model=wire.text_field(model),
        **wire.sample_fields([sample]),
    )
    n = int(z["n"])
    if n != 1:
        raise CanaryMismatchError(
            f"{what}: replica {host}:{port} answered n={n} "
            f"({wire.field_text(z.get('etype')) or wire.frame_detail(z) or 'no detail'}) "
            "instead of serving the probe"
        )
    return [np.array(z[f"h{i}"]) for i in range(int(z["nheads"]))]


def _reference_answers(router, rt, probes: list) -> list:
    """The live set's answers on the probe batch: each probe goes to the
    first active, unquarantined blue replica advertising its model."""
    answers = []
    stats = {r["rank"]: r for r in router.stats()["replicas"]}
    for model, sample in probes:
        target = None
        for rank in router.active_ranks():
            row = stats[rank]
            if model in row["models"] and not row["quarantined"]:
                target = row
                break
        if target is None:
            raise RuntimeError(
                f"rollout canary: no active live replica serves {model!r} "
                "to answer the reference probe"
            )
        answers.append(_probe_predict(
            rt, target["host"], target["port"], model, sample,
            what=f"rollout reference probe ({model}) on live replica "
                 f"{target['rank']}",
        ))
    return answers


def run_canary(router, green: list, probes: list,
               cfg: RolloutConfig, rt=None) -> dict:
    """The bit-identity gate, callable on its own: probe every green
    replica on the pinned batch and compare bit-for-bit against the live
    set. Returns ``{green_index: "ok"}`` per replica; raises
    :class:`CanaryMismatchError` on the first divergence."""
    if not probes:
        raise ValueError(
            "rollout canary requires probe samples (rollout.canary_probes "
            "of them); pass canary=False only for a known "
            "answer-compatible generation"
        )
    probes = list(probes)[: int(cfg.canary_probes)]
    own_rt = rt is None
    if own_rt:
        rt = wire.RoundTripper(
            cfg.probe_timeout_s, auth_token=router.cfg.auth
        )
    verdicts: dict = {}
    try:
        reference = _reference_answers(router, rt, probes)
        for g_i, (host, port) in enumerate(green):
            for (model, sample), ref in zip(probes, reference):
                got = _probe_predict(
                    rt, host, port, model, sample,
                    what=f"rollout canary probe ({model}) on green "
                         f"{host}:{port}",
                )
                if len(got) != len(ref):
                    raise CanaryMismatchError(
                        f"green {host}:{port} answered {len(got)} heads for "
                        f"{model!r}, live set answered {len(ref)}"
                    )
                for h_i, (a, b) in enumerate(zip(ref, got)):
                    if a.shape != b.shape or not np.array_equal(a, b):
                        diff = (
                            float(np.max(np.abs(
                                a.astype(np.float64) - b.astype(np.float64)
                            )))
                            if a.shape == b.shape else None
                        )
                        raise CanaryMismatchError(
                            f"green {host}:{port} diverges from the live "
                            f"set on {model!r} head {h_i}: shapes "
                            f"{b.shape} vs {a.shape}, max|diff| {diff} — "
                            "rollout refused, live set untouched"
                        )
            verdicts[g_i] = "ok"
            tel.emit("rollout", stage="canary", green=f"{host}:{port}", verdict="ok",
                     probes=len(probes))
    finally:
        if own_rt:
            rt.close()
    return verdicts


def _addresses(green) -> list:
    out = []
    for g in green:
        if isinstance(g, tuple):
            out.append((g[0], int(g[1])))
        else:
            out.append((getattr(g, "host", "127.0.0.1"), int(g.port)))
    return out


def blue_green_rollout(router, green, probes=None,
                       config: "RolloutConfig | dict | None" = None) -> dict:
    """Cut the fleet over from its current (blue) generation to ``green``.

    ``green`` — already-booted new-generation replicas: ``(host, port)``
    tuples or handles with ``.port`` (``ReplicaProcess``/``ReplicaHost``).
    ``probes`` — pinned ``(model, sample)`` pairs for the canary (required
    unless ``rollout.canary`` is off). Returns a report dict
    (``green_ranks``, ``blue_ranks``, per-rank drain verdicts, canary
    outcome). The caller owns the blue processes — terminate them after
    this returns (their ranks are retired, nothing routes to them)."""
    cfg = RolloutConfig.from_config(config).validate()
    addrs = _addresses(green)
    if not addrs:
        raise ValueError("rollout needs at least one green replica")
    blue = router.active_ranks()
    if not blue:
        raise RuntimeError("rollout: no active replicas to cut over from")
    tel.emit("rollout", stage="begin", blue=list(blue), green=[f"{h}:{p}" for h, p in addrs],
             canary=bool(cfg.canary))
    if cfg.canary:
        canary = run_canary(router, addrs, probes or [], cfg)
    else:
        canary = "skipped"
        tel.emit("rollout", stage="canary", verdict="skipped")
    # attach green FIRST: from this instant both generations are
    # dispatchable (bit-identical by the canary's proof), so the served-
    # model set never blinks and no queued request waits on the drain
    green_ranks = [router.attach(h, p) for h, p in addrs]
    tel.emit("rollout", stage="cutover", green_ranks=list(green_ranks))
    drained = {}
    for rank in blue:
        drained[rank] = router.retire(rank, timeout_s=cfg.drain_timeout_s)
    report = {
        "green_ranks": green_ranks,
        "blue_ranks": list(blue),
        "drained": drained,
        "canary": canary,
    }
    tel.emit("rollout", stage="complete", green_ranks=list(green_ranks), blue_ranks=list(blue),
             drained_clean=all(drained.values()))
    return report


__all__ = ["CanaryMismatchError", "blue_green_rollout", "run_canary"]
