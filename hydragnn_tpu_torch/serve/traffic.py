"""Synthetic serving traffic: open- and closed-loop request generation and
latency accounting.

Counterpart of ``hydragnn_tpu/serve/traffic.py``: a ``PredictionServer`` or a
``FleetRouter`` is driven through this one generator, so p50/p99 and
graphs/s are measured the same way everywhere (``chip_smoke.py``'s serving
bursts included).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .admission import AdmissionError, DeadlineExceededError, QueueFullError


@dataclass
class TrafficReport:
    """Latency/throughput summary of one traffic run. Latency is the
    client-observed submit→result-available wall time per request (measured
    via a done-callback on each future: queueing + coalescing wait +
    dispatch + result split + delivery into the future — everything short of
    the waiter's own wakeup scheduling, which no single-process measurement
    can see)."""

    n_requests: int = 0
    n_served: int = 0
    n_shed: int = 0
    n_deadline: int = 0
    wall_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    # per-tag splits (mixed-priority runs tag each request with its class;
    # empty for untagged runs). Deadline rejections and admission sheds
    # are counted apart, mirroring the untagged n_shed / n_deadline split.
    latencies_by_tag: dict = field(default_factory=dict)
    shed_by_tag: dict = field(default_factory=dict)
    deadline_by_tag: dict = field(default_factory=dict)

    def percentile_ms(self, q: float, tag: str | None = None) -> float | None:
        xs = (
            self.latencies_s if tag is None
            else self.latencies_by_tag.get(tag, [])
        )
        if not xs:
            return None
        return round(1e3 * float(np.percentile(xs, q)), 3)

    def summary(self) -> dict:
        out = {
            "n_requests": self.n_requests,
            "n_served": self.n_served,
            "n_shed": self.n_shed,
            "n_deadline_exceeded": self.n_deadline,
            "p50_ms": self.percentile_ms(50),
            "p99_ms": self.percentile_ms(99),
            "graphs_per_sec": (
                round(self.n_served / self.wall_s, 2) if self.wall_s > 0 else None
            ),
            "wall_s": round(self.wall_s, 4),
        }
        for tag in sorted(self.latencies_by_tag):
            out[f"p99_ms_{tag}"] = self.percentile_ms(99, tag=tag)
        for tag, n in sorted(self.shed_by_tag.items()):
            out[f"n_shed_{tag}"] = n
        for tag, n in sorted(self.deadline_by_tag.items()):
            out[f"n_deadline_{tag}"] = n
        return out


def zipf_duplicate_order(n_requests: int, n_samples: int, alpha: float = 1.1,
                         seed: int = 0) -> np.ndarray:
    """Seeded Zipf-duplicate request order: index ``k`` drawn with weight
    ``1/(k+1)^alpha`` over ``n_samples`` — the heavy-head popularity shape
    of real traffic ("everyone asks about the same few molecules"), which
    is what a content-addressed answer cache exists to exploit. Bounded
    (weights over exactly ``n_samples``, not rejection-clipped) so the
    draw stays deterministic per (n_requests, n_samples, alpha, seed)."""
    if n_samples < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.power(np.arange(1, n_samples + 1, dtype=np.float64),
                             float(alpha))
    weights /= weights.sum()
    return rng.choice(n_samples, size=int(n_requests), p=weights)


def mixed_priority_plan(n_requests: int, mix: dict | None = None,
                        seed: int = 0) -> list:
    """Seeded per-request priority classes. ``mix`` maps class name ->
    weight (normalized); default is an interactive-light / batch-heavy /
    best-effort-tail blend. Returns a list of class-name strings aligned
    with the request order."""
    mix = mix or {"interactive": 0.2, "batch": 0.5, "best_effort": 0.3}
    names = sorted(mix)
    weights = np.asarray([float(mix[k]) for k in names], np.float64)
    if (weights < 0).any() or weights.sum() <= 0:
        raise ValueError(f"bad priority mix {mix}")
    weights /= weights.sum()
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(names), size=int(n_requests), p=weights)
    return [names[int(i)] for i in picks]


def run_traffic(
    server,
    model: str,
    samples,
    n_requests: int,
    rate_hz: float | None = None,
    seed: int = 0,
    deadline_ms: float | None = None,
    timeout_s: float = 120.0,
    order=None,
    priorities=None,
) -> TrafficReport:
    """Drive ``n_requests`` single-graph requests at the server, drawing
    samples uniformly (seeded) from ``samples``.

    ``rate_hz``: open-loop Poisson arrivals at that mean rate — the
    "millions of users" shape, where arrival times don't wait for results.
    ``None`` = closed burst: submit as fast as admission allows (admission
    shedding then exercises the bounded queue; shed requests are retried
    once after a short backoff, then counted shed).

    ``order``: explicit per-request sample indices (e.g.
    :func:`zipf_duplicate_order` for duplicate-heavy cache traffic);
    ``None`` keeps the original uniform draw — BYTE-COMPATIBLE with
    pre-fleet runs: the same seed consumes the same rng stream whether or
    not the new arguments exist. ``priorities``: per-request class names
    (:func:`mixed_priority_plan`) forwarded to routers that take a
    ``priority=`` submit kwarg; latencies/sheds are then also split per
    class in the report.
    """
    rng = np.random.default_rng(seed)
    if order is None:
        order = rng.integers(0, len(samples), size=n_requests)
    else:
        order = np.asarray(order)
        if len(order) != n_requests:
            raise ValueError(
                f"order has {len(order)} entries for {n_requests} requests"
            )
    if priorities is not None and len(priorities) != n_requests:
        raise ValueError(
            f"priorities has {len(priorities)} entries for "
            f"{n_requests} requests"
        )
    report = TrafficReport(n_requests=n_requests)
    futures = []
    latencies = []  # appended from done-callbacks (dispatcher threads)
    by_tag: dict = {}

    def _submit(sample, tag):
        t_sub = time.perf_counter()
        kw = {} if tag is None else {"priority": tag}
        fut = server.submit(model, sample, deadline_ms=deadline_ms, **kw)

        def _done(f, t_sub=t_sub, tag=tag):
            if f.exception() is None:
                # submit -> result-available: the client-observed latency,
                # stamped the instant the future resolves (polling result()
                # later would overstate early-completing requests)
                lat = time.perf_counter() - t_sub
                latencies.append(lat)
                if tag is not None:
                    by_tag.setdefault(tag, []).append(lat)

        fut.add_done_callback(_done)
        futures.append((fut, tag))

    def _count_shed(tag):
        report.n_shed += 1
        if tag is not None:
            report.shed_by_tag[tag] = report.shed_by_tag.get(tag, 0) + 1

    t0 = time.perf_counter()
    next_arrival = t0
    for i in range(n_requests):
        if rate_hz:
            next_arrival += float(rng.exponential(1.0 / rate_hz))
            now = time.perf_counter()
            if next_arrival > now:
                time.sleep(next_arrival - now)
        sample = samples[int(order[i])]
        tag = None if priorities is None else priorities[i]
        try:
            _submit(sample, tag)
        except QueueFullError:
            # queue-full is the RETRYABLE rejection (backpressure): one
            # retry after a beat, still-full counts as shed. Every other
            # admission error (unknown model, incompatible sample, closed
            # server) is a configuration bug — propagate, don't launder it
            # into the shed count.
            time.sleep(0.002)
            try:
                _submit(sample, tag)
            except QueueFullError:
                _count_shed(tag)
    for fut, tag in futures:
        try:
            fut.result(timeout=timeout_s)
            report.n_served += 1
        except DeadlineExceededError:
            report.n_deadline += 1
            if tag is not None:
                report.deadline_by_tag[tag] = (
                    report.deadline_by_tag.get(tag, 0) + 1
                )
        except AdmissionError:
            _count_shed(tag)
    report.wall_s = time.perf_counter() - t0
    # result() can unblock BEFORE the future's done-callback runs (waiters
    # are notified first in CPython), so give the last callbacks a bounded
    # beat to land — otherwise the tail request's latency goes missing
    wait_until = time.perf_counter() + 1.0
    while len(latencies) < report.n_served and time.perf_counter() < wait_until:
        time.sleep(0.001)
    report.latencies_s = list(latencies)
    report.latencies_by_tag = {k: list(v) for k, v in by_tag.items()}
    return report


__all__ = [
    "TrafficReport",
    "mixed_priority_plan",
    "run_traffic",
    "zipf_duplicate_order",
]
