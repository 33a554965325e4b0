"""The fleet router: one front door over N prediction replicas.

Counterpart of ``hydragnn_tpu/serve/fleet/router.py`` on the port's wire
transport (``utils.wire``):

* **priority classes** — every request is ``interactive`` / ``batch`` /
  ``best_effort``, each class with its own bounded admission queue
  (``Serving.fleet.budget_*``). A class at budget sheds new arrivals of
  that class with the same typed ``QueueFullError`` the in-process
  admission raises. Dispatch drains in strict priority order, and expired
  requests shed typed (``DeadlineExceededError``) at dequeue.
* **least-loaded dispatch** — each request goes to the healthy replica
  serving its model with the fewest in-flight round-trips, ties rotated;
  ``inflight_per_replica`` bounds the window.
* **failover** — a transport fault (connect refused, timeout, a severed
  dribble) quarantines the replica on the doubling re-probe clock
  (``wire.HealthTable``), evicts its pooled sockets and requeues the
  in-flight request at the head of its class: a replica dying mid-request
  costs a retry on a sibling, never a lost request. Protocol errors (an
  auth-token mismatch, a replica-side exception) reject the request with
  the cause.
* **answer cache** — a content-addressed byte-budgeted LRU
  (``fleet.cache``) keyed on canonicalized graph bytes, model and quant
  flag; a hit resolves at admission with arrays byte-identical to replica
  compute.

Telemetry, as the JAX router's: every counter of :meth:`FleetRouter.stats`
is also the registry's ``fleet_requests{event}``; with trace propagation on
each request gets a ``request_id`` (the caller's ambient one, or a fresh
one) that its ``fleet_admit``, ``fleet_dispatch``, ``fleet_cache_hit`` /
``fleet_cache_fill`` and ``fleet_reply`` records carry and that the
predict frame takes to the replica (``replica_execute`` there);
``failover``, ``shed``, ``fleet_drain_begin``, ``fleet_retire`` and
``quarantine_lifted`` are journalled; :meth:`FleetRouter.metrics` is the
fleet-wide view over every replica's ``metrics`` op.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from ... import telemetry as tel
from ...utils import wire
from ...utils.retry import RetryPolicy
from .. import admission
from ..admission import (
    DeadlineExceededError,
    QueueFullError,
    Request,
    ServerClosedError,
    UnknownModelError,
)
from .cache import AnswerCache, answer_key
from .config import FleetConfig, PRIORITY_CLASSES

# the failover path retries ACROSS replicas; a per-replica backoff loop
# would multiply an outage by the replica count (same policy as the store)
_ONE_ATTEMPT = RetryPolicy(attempts=1)


@dataclasses.dataclass
class RoutedRequest(Request):
    """A :class:`~hydragnn_tpu_torch.serve.admission.Request` plus routing state."""

    model: str = ""
    priority: str = "interactive"
    digest: str | None = None  # answer-cache key (None = cache disabled)
    attempts: int = 0          # replica round-trips consumed (failover cap)
    # the fleet-wide trace id every stage of this request journals under
    # (None: propagation off)
    request_id: str | None = None


@dataclasses.dataclass
class _Replica:
    rank: int
    host: str
    port: int
    models: tuple
    quantized: dict
    inflight: int = 0
    served: int = 0
    failures: int = 0
    # drain/retire lifecycle (guarded-by: _work, like the mutable counters
    # above): ``draining`` stops NEW dispatch while in-flight round-trips
    # finish; ``retired`` removes the replica from every routing/metrics
    # surface. Ranks stay stable — a retired replica keeps its list slot
    # (callers hold ranks across scale events), it is just never picked.
    draining: bool = False
    retired: bool = False


class FleetRouter:
    """Front door over attached replicas. Lifecycle::

        router = FleetRouter({"cache_bytes": 1 << 24, "peer_timeout": 5.0})
        router.attach("127.0.0.1", replica_a.port)
        router.attach("127.0.0.1", replica_b.port)
        router.start()
        fut = router.submit("mace_v2", sample, priority="interactive",
                            deadline_ms=50)
        heads = fut.result()["heads"]
        router.stop()

    ``attach`` pings the replica over the wire and trusts only what the
    validated pong advertises (ready bit, model list, quant flags) — a
    replica that has not finished its warm-up is not routable because it
    does not LISTEN until warm-up completes (the worker boot contract).
    """

    def __init__(self, config: "FleetConfig | dict | None" = None):
        self.cfg = FleetConfig.from_config(config).validate()
        self._rt = wire.RoundTripper(
            self.cfg.peer_timeout, auth_token=self.cfg.auth
        )
        self._health = wire.HealthTable(
            self.cfg.quarantine_base_s, self.cfg.quarantine_cap_s,
            jitter=self.cfg.quarantine_jitter,
        )
        self.cache = AnswerCache(self.cfg.cache_bytes)
        self._replicas: list[_Replica] = []  # guarded-by: _work
        # _work guards queues + inflight + counters; future resolution and
        # network round-trips happen OUTSIDE it (client done-callbacks run
        # inline on set_result — resolving under the lock could re-enter)
        self._work = threading.Condition(threading.Lock())
        self._queues: dict[str, deque] = {c: deque() for c in PRIORITY_CLASSES}  # guarded-by: _work
        self.counters = {  # guarded-by: _work
            "submitted": 0, "served": 0, "cache_hits": 0, "failed": 0,
            "cancelled": 0, "shed": 0, "shed_deadline": 0,
            "failovers": 0, "requeues": 0,
            **{f"shed_{c}": 0 for c in PRIORITY_CLASSES},
        }
        # per-class sliding latency windows (replica-served requests only —
        # cache hits would flatter the tail the autoscaler watches);
        # bounded deques, so stats() percentiles cost O(window) not O(traffic)
        self._latency: dict[str, deque] = {  # guarded-by: _work
            c: deque(maxlen=256) for c in PRIORITY_CLASSES
        }
        self._running = False
        self._stopping = False
        self._rot = 0  # guarded-by: _work
        self._dispatcher: threading.Thread | None = None
        self._exec: ThreadPoolExecutor | None = None
        self._probe_stop = threading.Event()
        self._probe_thread: threading.Thread | None = None

    # -- topology -----------------------------------------------------------

    def attach(self, host: str, port: int) -> int:
        """Register one replica by address; returns its rank. Validates
        the ping pong (ready bit) through the shared ``wire.check_pong``
        and records the advertised model list + quant flags (the quant
        flag is part of the answer-cache key). Auth mismatch is LOUD."""
        z = self._rt.round_trip(
            (host, port), host, port, policy=_ONE_ATTEMPT,
            what=f"fleet attach ping to {host}:{port}",
            ping=np.asarray(1, np.int64),
        )
        self._check_protocol(z, host, port)
        wire.check_pong(z, f"attach of replica {host}:{port}", ready=1)
        names = tuple(
            n for n in wire.field_text(z.get("models")).split(",") if n
        )
        if not names:
            raise RuntimeError(
                f"replica {host}:{port} advertises no models; refusing to "
                "route to it"
            )
        qflags = np.asarray(z.get("quantized", np.zeros(len(names))), np.int64)
        quantized = {n: bool(qflags[i]) for i, n in enumerate(names)}
        with self._work:
            # quant flags must agree across replicas of one model: answers
            # differ between modes, so both least-loaded dispatch and the
            # (quant-flag-keyed) answer cache would mix them — a precision-
            # heterogeneous fleet is a configuration error, refused here
            # (retired generations don't constrain the new one)
            for r in self._replicas:
                if r.retired:
                    continue
                for m in set(r.models) & set(names):
                    if r.quantized.get(m) != quantized.get(m):
                        raise RuntimeError(
                            f"replica {host}:{port} serves {m!r} "
                            f"{'int8' if quantized[m] else 'fp32'} but "
                            f"replica {r.rank} serves it "
                            f"{'int8' if r.quantized.get(m) else 'fp32'} — "
                            "a fleet must serve one model in one precision"
                        )
            rank = len(self._replicas)
            self._replicas.append(_Replica(
                rank=rank, host=host, port=port, models=names,
                quantized=quantized,
            ))
            self._work.notify_all()
        return rank

    def _models_union(self) -> set:
        # draining replicas still count: their in-flight work finishes and,
        # during a cutover, the green generation is attached BEFORE blue
        # drains — so the served-model set never blinks empty
        return {m for r in self._replicas if not r.retired for m in r.models}

    def begin_drain(self, rank: int) -> None:
        """Stop dispatching NEW work to ``rank``; in-flight round-trips
        finish and resolve normally. Queued requests simply route to the
        other replicas — nothing is dropped or re-ordered."""
        with self._work:
            self._replicas[rank].draining = True
            self._work.notify_all()
        tel.emit("fleet_drain_begin", replica=rank)

    def retire(self, rank: int, timeout_s: float = 30.0) -> bool:
        """Drain ``rank`` and remove it from every routing surface. Blocks
        until its in-flight count hits zero (each decrement notifies
        ``_work``) or ``timeout_s`` passes; either way the replica is
        retired — on timeout its still-in-flight requests fail over through
        the normal transport-fault path when the process dies, so the
        zero-lost-requests property holds regardless. Returns True when the
        drain completed cleanly inside the timeout."""
        self.begin_drain(rank)
        deadline = time.monotonic() + float(timeout_s)
        with self._work:
            r = self._replicas[rank]
            while r.inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._work.wait(min(remaining, 0.1))
            left = r.inflight
            drained = left == 0
            r.retired = True
            self._work.notify_all()
        self._health.lift(rank)  # no point probing a retired replica
        self._rt.evict((r.host, r.port))
        tel.emit("fleet_retire", replica=rank, drained=bool(drained))
        if not drained:
            warnings.warn(
                f"fleet replica {rank} retired with {left} round-trips "
                f"still in flight after {timeout_s}s drain; they resolve or "
                "fail over on their own"
            )
        return drained

    def active_ranks(self) -> list:
        """Ranks currently eligible for new dispatch (not draining, not
        retired) — the live set a rollout cuts over from and the replica
        count the autoscaler budgets against."""
        with self._work:
            return [
                r.rank for r in self._replicas
                if not r.draining and not r.retired
            ]

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FleetRouter":
        if self._running:
            return self
        if not self._replicas:
            raise RuntimeError("no replicas attached")
        self._stopping = False
        # fresh stop signal + transport: a restart after stop() must be
        # able to probe quarantined replicas again (the old event stays
        # set) and to pool sockets again (the old pool is closed)
        self._probe_stop = threading.Event()
        if self._rt.pool._closed:
            self._rt = wire.RoundTripper(
                self.cfg.peer_timeout, auth_token=self.cfg.auth
            )
        # headroom over the boot-time replica count: the autoscaler and
        # blue/green rollouts ATTACH replicas while the router is live, and
        # an executor sized exactly to the boot topology would serialize
        # the new capacity's round-trips behind the old pool
        self._exec = ThreadPoolExecutor(
            max_workers=max(
                16,
                max(1, len(self._replicas))
                * int(self.cfg.inflight_per_replica),
            ),
            thread_name_prefix="fleet-send",
        )
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="fleet-dispatch", daemon=True
        )
        self._dispatcher.start()
        self._running = True
        return self

    def stop(self) -> None:
        if not self._running:
            return
        with self._work:
            self._stopping = True
            self._work.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=10.0)
        if self._exec is not None:
            # in-flight round-trips finish and resolve their futures; a
            # failed one requeues and is drained below
            self._exec.shutdown(wait=True)
        drained: list[RoutedRequest] = []
        with self._work:
            for q in self._queues.values():
                drained.extend(q)
                q.clear()
        for req in drained:
            if req.reject(ServerClosedError(
                "router stopped with the request queued"
            )):
                self._count("cancelled")
        self._probe_stop.set()
        self._rt.close()  # pooled sockets don't outlive the router
        self._running = False

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request plane ------------------------------------------------------

    def submit(self, model: str, sample, priority: str = "interactive",
               deadline_ms: float | None = None) -> Future:
        """Admit one request into its priority class; returns its Future.
        Sheds with a typed exception RAISED here when admission fails
        (class budget full / unknown model / stopped router); a cache hit
        resolves the future immediately — byte-identical to compute — and
        never touches a replica."""
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {priority!r}; classes: {PRIORITY_CLASSES}"
            )
        if not self._running:
            raise ServerClosedError("router not started")
        if model not in self._models_union():
            raise UnknownModelError(
                f"no attached replica serves {model!r}; serving: "
                f"{sorted(self._models_union())}"
            )
        self._count("submitted")
        deadline = (
            time.monotonic() + deadline_ms / 1e3 if deadline_ms else None
        )
        req = RoutedRequest(
            sample=sample, deadline=deadline, model=model, priority=priority
        )
        if tel.propagate_enabled():
            # the caller's ambient request_id (an upstream tier may have
            # minted one) or a fresh one: every stage of this request's
            # timeline shares it
            req.request_id = tel.get_context().get("request_id") or tel.new_request_id()
            tel.emit("fleet_admit", request_id=req.request_id, model=model,
                     **{"class": priority})
        if self.cfg.cache_bytes > 0:
            quant = any(
                r.quantized.get(model, False) for r in self._replicas
            )
            req.digest = answer_key(sample, model, quantized=quant)
            hit = self.cache.get(req.digest)
            if hit is not None:
                self._count("cache_hits")
                self._count("served")
                if req.request_id is not None:
                    tel.emit("fleet_cache_hit", request_id=req.request_id, model=model)
                if req.claim():
                    req.future.set_result({
                        "heads": hit,
                        "latency_s": time.monotonic() - req.enqueued_at,
                        "cached": True,
                    })
                return req.future
        shed_full = False
        with self._work:
            q = self._queues[priority]
            if len(q) >= self.cfg.budget(priority):
                self.counters[f"shed_{priority}"] += 1
                self.counters["shed"] += 1
                shed_full = True
            else:
                q.append(req)
                self._work.notify_all()
        if shed_full:
            tel.counter("fleet_requests", event=f"shed_{priority}").inc()
            tel.counter("fleet_requests", event="shed").inc()
            tel.emit("shed", **{"class": priority, "reason": "queue_full"})
            raise QueueFullError(
                f"{priority} class at budget "
                f"({self.cfg.budget(priority)}); request shed"
            )
        return req.future

    def predict(self, model: str, samples, priority: str = "interactive",
                deadline_ms: float | None = None, timeout: float = 60.0):
        """Synchronous convenience mirroring ``PredictionServer.predict``."""
        futures = [
            self.submit(model, s, priority=priority, deadline_ms=deadline_ms)
            for s in samples
        ]
        return [f.result(timeout=timeout)["heads"] for f in futures]

    def _count(self, key: str, by: int = 1) -> None:
        with self._work:
            self.counters[key] += by
        # the registry's series beside the stats() dict (metrics() reads it)
        tel.counter("fleet_requests", event=key).inc(by)

    # -- dispatch -----------------------------------------------------------

    def _pop_dispatchable_locked(
        self,
    ) -> "tuple[RoutedRequest | None, _Replica | None, list]":
        """Strict-priority pop of the oldest request whose model has a free
        replica slot — the slot is RESERVED (inflight++) under the same
        lock hold — plus the expired requests swept past on the way
        (rejected OUTSIDE the lock by the caller).

        A request whose model has no free slot STAYS QUEUED. The previous
        dispatcher popped first and parked on the slot wait holding the
        request, which (a) made class-budget accounting lie by one — a
        popped-but-undispatched request no longer counted against its
        class, so the class over-admitted past its budget — and (b)
        inverted priority: a popped best_effort parked on the slot wait
        beat any interactive request that arrived while it waited. Popping
        and reserving atomically makes both properties hold by
        construction instead of by timing luck."""
        expired: list = []
        # models probed slotless THIS scan: nothing can free a slot while
        # we hold _work, so N queued requests of one saturated model cost
        # one _pick_locked probe, not N (and the deque is walked by
        # iteration + one rebuild, never by O(n) index/delete)
        no_slot: set[str] = set()
        for cls in PRIORITY_CLASSES:
            q = self._queues[cls]
            if not q:
                continue
            chosen: "tuple[RoutedRequest, _Replica] | None" = None
            kept: list = []
            for req in q:
                if chosen is not None:
                    kept.append(req)
                    continue
                if req.expired():
                    expired.append(req)
                    continue
                if req.model in no_slot:
                    # no slot for THIS model: later requests of another
                    # model may still dispatch (strict priority, no
                    # cross-model head-of-line blocking); FIFO within
                    # (class, model) holds
                    kept.append(req)
                    continue
                target = self._pick_locked(req.model)
                if target is None:
                    no_slot.add(req.model)
                    kept.append(req)
                    continue
                target.inflight += 1
                chosen = (req, target)
            if len(kept) != len(q):
                q.clear()
                q.extend(kept)
            if chosen is not None:
                return chosen[0], chosen[1], expired
        return None, None, expired

    def _shed_expired(self, expired: list) -> None:
        for req in expired:
            if req.reject(DeadlineExceededError(
                "deadline passed while queued at the router"
            )):
                self._count("shed_deadline")
                self._count("shed")
                tel.emit("shed", **{"class": req.priority}, model=req.model, reason="deadline")
            else:
                self._count("cancelled")

    def _pick_locked(self, model: str) -> "_Replica | None":
        """Least-loaded HEALTHY replica advertising ``model`` with a free
        in-flight slot; ties rotate. Quarantined replicas are a last
        resort only when the model has NO healthy replica at all — a
        healthy sibling that is merely slot-saturated means WAIT for its
        slot (return None), not "burn one of the request's bounded
        failover attempts on a peer we already know is down": under a
        replica kill the survivor's window saturates instantly, and the
        old free-slots-beat-health order hammered every queued request
        into the dead peer until its attempt cap killed it."""
        avail = [
            r for r in self._replicas
            if model in r.models and not r.draining and not r.retired
            and r.inflight < self.cfg.inflight_per_replica
        ]
        if not avail:
            return None
        order = self._health.order([r.rank for r in avail], rot=self._rot)
        self._rot += 1
        by_rank = {r.rank: r for r in avail}
        pool = [by_rank[k] for k in order if not self._health.quarantined(k)]
        if not pool:
            if any(
                model in r.models and not r.draining and not r.retired
                and not self._health.quarantined(r.rank)
                for r in self._replicas
            ):
                return None  # healthy-but-saturated exists: wait for it
            pool = [by_rank[order[0]]]  # all quarantined: a request is
            # the cheapest live probe — try the soonest-due peer
        best = pool[0]
        for r in pool[1:]:
            if r.inflight < best.inflight:
                best = r
        return best

    def _dispatch_loop(self) -> None:
        while True:
            with self._work:
                if self._stopping:
                    return  # stop() drains whatever is still queued
                req, target, expired = self._pop_dispatchable_locked()
                if req is None and not expired:
                    # every state change notifies (submit, slot free in
                    # _serve_one's finally, requeue, attach, stop); the
                    # timeout is NOT the wakeup mechanism — it only bounds
                    # the deadline-expiry sweep on an otherwise idle router
                    self._work.wait(0.1)
                    continue
            self._shed_expired(expired)
            if req is None:
                continue
            # the pop already re-checked expiry at dequeue and reserved the
            # slot under the same lock hold — nothing can age between here
            # and the executor handoff but microseconds
            self._exec.submit(self._serve_one, req, target)

    # -- replica round-trip -------------------------------------------------

    def _serve_one(self, req: RoutedRequest, replica: _Replica) -> None:
        # the request's trace id becomes this dispatcher thread's journal
        # scope: every record below carries it, and RoundTripper.request
        # ships it to the replica inside the frame
        with tel.scoped_context(request_id=req.request_id):
            self._serve_one_scoped(req, replica)

    def _serve_one_scoped(self, req: RoutedRequest, replica: _Replica) -> None:
        try:
            fields = {
                "predict": np.asarray(1, np.int64),
                "model": wire.text_field(req.model),
                **wire.sample_fields([req.sample]),
            }
            if req.request_id is not None:
                tel.emit("fleet_dispatch", model=req.model, replica=replica.rank,
                         attempt=req.attempts)
            try:
                z = self._rt.round_trip(
                    (replica.host, replica.port), replica.host, replica.port,
                    policy=_ONE_ATTEMPT,
                    what=f"fleet predict on replica {replica.rank} "
                         f"({replica.host}:{replica.port})",
                    **fields,
                )
            except (ConnectionError, OSError) as e:
                # transport fault: quarantine + requeue — the request is
                # idempotent, a sibling replica serves it (zero lost)
                self._mark_replica_down(replica, e)
                self._requeue(req, e)
                return
            try:
                self._resolve(req, replica, z)
            except Exception as e:
                # a malformed reply (missing fields, bad shapes) must fail
                # THIS request loudly, never leave its claimed future
                # unresolved — an unhandled raise here would hang the
                # client until its own timeout with zero diagnostics
                exc = RuntimeError(
                    f"replica {replica.rank} answered an undecodable "
                    f"predict reply ({type(e).__name__}: {e})"
                )
                try:
                    claimed = req.claim()
                except RuntimeError:
                    claimed = True  # _resolve claimed it before raising
                if claimed:
                    if not req.future.done():
                        req.future.set_exception(exc)
                    self._count("failed")
                else:
                    self._count("cancelled")
        finally:
            with self._work:
                replica.inflight -= 1
                self._work.notify_all()

    def _resolve(self, req: RoutedRequest, replica: _Replica, z: dict) -> None:
        n = int(z["n"])
        if n == -4:
            # typed admission shed from the replica, re-raised as the SAME
            # serve.admission class. A transiently full replica queue
            # requeues (least-loaded may have raced a burst); every other
            # shed is an answer about the REQUEST, not the replica.
            etype = wire.field_text(z.get("etype"), "AdmissionError")
            detail = wire.field_text(z.get("detail"))
            exc_cls = getattr(admission, etype, admission.AdmissionError)
            if exc_cls is QueueFullError:
                # transient backpressure: retry at the TAIL after a beat
                # (head-requeue with no backoff would hammer the same full
                # replica queue in a hot loop)
                time.sleep(0.002)
                self._requeue(req, exc_cls(detail), head=False)
                return
            if req.reject(exc_cls(f"replica {replica.rank}: {detail}")):
                self._count("shed")
            else:
                self._count("cancelled")
            return
        if n < 0:
            # protocol errors stay LOUD (never failover): auth mismatch and
            # replica-side exceptions are configuration/server bugs a
            # sibling replica would just repeat — or worse, mask
            if n == -2:
                exc = RuntimeError(
                    f"fleet predict rejected by replica {replica.rank} "
                    f"({replica.host}:{replica.port}): auth token mismatch "
                    "(pass the same Serving.fleet.auth to router and "
                    "replicas)"
                )
            else:
                exc = RuntimeError(
                    f"replica {replica.rank} failed serving the request: "
                    f"{wire.frame_detail(z) or 'unknown error'}"
                )
            if req.reject(exc):
                self._count("failed")
            else:
                self._count("cancelled")
            return
        heads = [np.array(z[f"h{i}"]) for i in range(int(z["nheads"]))]
        self._health.lift(replica.rank)  # it answered: clear any suspicion
        latency_s = time.monotonic() - req.enqueued_at
        with self._work:
            replica.served += 1
            # the autoscaler's SLO signal: queue wait + round-trip, per
            # class, recorded for every replica-served answer (even ones a
            # racing cancel makes unclaimable — the latency was real)
            self._latency[req.priority].append(latency_s)
        if req.digest is not None:
            # insert BEFORE resolving the future: a client that resubmits
            # the same graph the instant its result lands must find the
            # cache populated, not race the insert
            self.cache.put(req.digest, heads)
            if req.request_id is not None:
                tel.emit("fleet_cache_fill", model=req.model)
        if not req.claim():
            self._count("cancelled")
            return
        if req.request_id is not None:
            tel.emit("fleet_reply", model=req.model, replica=replica.rank,
                     latency_s=round(latency_s, 6))
        req.future.set_result({
            "heads": heads,
            "latency_s": latency_s,
            "replica": replica.rank,
            "cached": False,
        })
        self._count("served")

    def _requeue(self, req: RoutedRequest, err: BaseException,
                 head: bool = True) -> None:
        req.attempts += 1
        cap = max(4, 2 * len(self._replicas))
        if req.attempts >= cap:
            # keep the failure TYPED: a replica-side admission shed that
            # exhausted its retries is still an AdmissionError (callers
            # handle those); only transport faults become ConnectionError
            exc = err if isinstance(err, admission.AdmissionError) else (
                ConnectionError(
                    f"request failed on {req.attempts} replica "
                    f"round-trip(s); last error: "
                    f"{type(err).__name__}: {err}"
                )
            )
            if req.reject(exc):
                self._count("failed")
            else:
                self._count("cancelled")
            return
        requeued = False
        with self._work:
            if self._stopping:
                # stop() already drained (or is draining) the queues: fail
                # the future now instead of parking it forever
                pass
            else:
                self._count_locked("requeues")
                q = self._queues[req.priority]
                q.appendleft(req) if head else q.append(req)
                self._work.notify_all()
                requeued = True
        if requeued:
            tel.counter("fleet_requests", event="requeues").inc()
            return
        if req.reject(ServerClosedError(
            "router stopped while the request was failing over"
        )):
            self._count("cancelled")

    def _count_locked(self, key: str, by: int = 1) -> None:
        # caller holds _work; the registry's series is written by the
        # caller after the release (no telemetry lock under _work)
        self.counters[key] += by

    def _mark_replica_down(self, replica: _Replica, err: BaseException) -> None:
        fresh = self._health.bump(replica.rank)
        self._rt.evict((replica.host, replica.port))
        with self._work:
            replica.failures += 1
            self.counters["failovers"] += 1
        tel.counter("fleet_requests", event="failovers").inc()
        tel.emit("failover", replica=replica.rank, host=replica.host, port=replica.port,
                 error=type(err).__name__, fresh_quarantine=bool(fresh))
        if fresh:
            warnings.warn(
                f"fleet replica {replica.rank} ({replica.host}:"
                f"{replica.port}) is down ({type(err).__name__}: {err}): "
                "quarantined, in-flight requests fail over to siblings"
            )
        self._ensure_prober()

    # -- health probing ------------------------------------------------------

    def _ensure_prober(self) -> None:
        with self._health.lock:
            if self._probe_thread is not None and self._probe_thread.is_alive():
                return
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="fleet-prober", daemon=True
            )
            self._probe_thread.start()

    def _probe_loop(self) -> None:
        """The health prober:
        ping due quarantined replicas (watchdog-guarded — a replica reborn
        as a dribbler must not wedge the singleton prober) and lift the
        quarantine only when the validated pong advertises the SAME
        identity it was attached under (ready + model list) — a replica
        restarted with different models must stay quarantined rather than
        silently serve the wrong endpoint set."""
        while not self._probe_stop.wait(self.cfg.probe_interval):
            with self._health.lock:
                if not self._health.entries:
                    self._probe_thread = None
                    return
            for rank in self._health.due_probes():
                replica = self._replicas[rank]
                try:
                    z = self._rt.round_trip(
                        (replica.host, replica.port),
                        replica.host, replica.port, policy=_ONE_ATTEMPT,
                        what=f"fleet probe of replica {rank}",
                        ping=np.asarray(1, np.int64),
                    )
                    self._check_protocol(z, replica.host, replica.port)
                    wire.check_pong(
                        z, f"probe of fleet replica {rank}", ready=1
                    )
                    advertised = wire.field_text(z.get("models"))
                    if advertised != ",".join(replica.models):
                        raise ConnectionError(
                            f"replica {rank} reborn with models "
                            f"[{advertised}], attached as "
                            f"[{','.join(replica.models)}]"
                        )
                except (ConnectionError, OSError):
                    self._health.bump(rank)
                    continue
                except RuntimeError:
                    # protocol rejection (e.g. auth flip): stays suspect,
                    # but keep probing — the operator may fix the config
                    self._health.bump(rank)
                    continue
                if self._health.lift(rank) is not None:
                    tel.emit("quarantine_lifted", replica=rank)
                    warnings.warn(
                        f"fleet replica {rank} ({replica.host}:"
                        f"{replica.port}) answers again: quarantine lifted"
                    )

    # -- protocol / stats ----------------------------------------------------

    @staticmethod
    def _check_protocol(z: dict, host: str, port: int) -> None:
        n = int(np.asarray(z.get("n", 0)).reshape(-1)[0]) if "n" in z else 0
        if n == -2:
            raise RuntimeError(
                f"replica {host}:{port} rejected the request: auth token "
                "mismatch (pass the same Serving.fleet.auth everywhere)"
            )
        if n == -3:
            raise RuntimeError(
                f"replica {host}:{port} failed: "
                f"{wire.frame_detail(z) or 'unknown error'}"
            )

    def replica_stats(self, rank: int) -> dict:
        """The replica's ``stats`` wire op, decoded: per-endpoint queue
        depth, shed counters and ``steady_captures`` (CUDA graphs captured
        since the replica advertised ready: 0 on a warm replica)."""
        r = self._replicas[rank]
        z = self._rt.round_trip(
            (r.host, r.port), r.host, r.port, policy=_ONE_ATTEMPT,
            what=f"fleet stats of replica {rank}",
            stats=np.asarray(1, np.int64),
        )
        self._check_protocol(z, r.host, r.port)
        return json.loads(wire.field_text(z["stats"]))

    def stats(self) -> dict:
        with self._work:
            c = dict(self.counters)
            depths = {cls: len(q) for cls, q in self._queues.items()}
            latency = {
                cls: (
                    round(
                        float(np.percentile(np.asarray(win), 99)) * 1e3, 3
                    )
                    if win else None
                )
                for cls, win in self._latency.items()
            }
            replicas = [
                {
                    "rank": r.rank, "host": r.host, "port": r.port,
                    "models": list(r.models), "inflight": r.inflight,
                    "served": r.served, "failures": r.failures,
                    "quarantined": self._health.quarantined(r.rank),
                    "draining": r.draining, "retired": r.retired,
                }
                for r in self._replicas
            ]
            active = sum(
                1 for r in self._replicas if not r.draining and not r.retired
            )
        c["queue_depths"] = depths
        # p99 over the per-class sliding windows (replica-served requests;
        # None = no traffic in the window yet) — the autoscaler's SLO input
        c["latency_p99_ms"] = latency
        c["replicas"] = replicas
        c["active_replicas"] = active
        c["cache"] = self.cache.stats()
        # the derived values as gauges (the counters are dual-written where
        # they count)
        tel.publish("fleet", c)
        for cls, depth in depths.items():
            tel.gauge("fleet_queue_depth", **{"class": cls}).set(depth)
        return c

    def replica_metrics(self, rank: int) -> dict:
        """One replica's ``metrics`` wire op, decoded: ``{"stats",
        "registry"}``, its stats dict and its whole telemetry registry."""
        r = self._replicas[rank]
        z = self._rt.round_trip(
            (r.host, r.port), r.host, r.port, policy=_ONE_ATTEMPT,
            what=f"fleet metrics of replica {rank}",
            metrics=np.asarray(1, np.int64),
        )
        self._check_protocol(z, r.host, r.port)
        return json.loads(wire.field_text(z["metrics"]))

    def metrics(self) -> dict:
        """The fleet-wide telemetry view: the router's stats and registry,
        every reachable replica's ``metrics`` answer, and an aggregate row
        (replicas reporting, total queue depth, sheds, served,
        ``steady_captures``, the cache hit rate). A quarantined or
        unreachable replica reports an ``error`` entry instead of hanging
        the aggregation."""
        out: dict = {"router": self.stats(), "registry": tel.snapshot(), "replicas": {}}
        live = [r for r in list(self._replicas) if not r.retired]
        agg = {"replicas_total": len(live), "replicas_reporting": 0, "queue_depth": 0,
               "shed": 0, "served": 0, "steady_captures": 0}
        for r in live:
            if self._health.quarantined(r.rank):
                out["replicas"][str(r.rank)] = {"error": "quarantined"}
                continue
            try:
                m = self.replica_metrics(r.rank)
            except (ConnectionError, OSError, RuntimeError) as e:
                out["replicas"][str(r.rank)] = {"error": f"{type(e).__name__}: {e}"}
                continue
            out["replicas"][str(r.rank)] = m
            stats = m.get("stats", {})
            agg["replicas_reporting"] += 1
            for key in ("queue_depth", "shed", "served", "steady_captures"):
                agg[key] += int(stats.get(key, 0) or 0)
        agg["cache_hit_rate"] = out["router"]["cache"].get("hit_rate")
        out["aggregate"] = agg
        tel.publish("fleet_aggregate", agg)
        return out


__all__ = ["FleetRouter", "RoutedRequest"]
