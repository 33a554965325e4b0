"""Paired-window ABBA verdict discipline.

Counterpart of ``hydragnn_tpu/utils/abtest.py``, the same arithmetic, so
the port's A/B measurements issue verdicts as the JAX package's do:
overhead is the median of PAIRED per-window differences over the A-arm
median, and the noise floor is the WORST of the pair-difference IQR and
each arm's own window IQR (the pair spread alone underestimates the noise
when both arms drift together). ``pass``/``fail`` are issued only when the
measurement resolves the budget; otherwise ``inconclusive`` records the
numbers without a verdict.
"""

from __future__ import annotations

import statistics


def iqr(xs):
    """Interquartile-ish range; under 4 samples, the full range (>= 0)."""
    s = sorted(xs)
    if len(s) < 4:  # too few windows for quartiles: full range (>= 0)
        return s[-1] - s[0]
    q = len(s) // 4
    return s[-1 - q] - s[q]


def abba_verdict(a_ms, b_ms, budget_pct: float):
    """``(overhead_pct, noise_pct, verdict)`` for paired ABBA windows of the
    A (baseline) and B (candidate) arms against an overhead budget in
    percent of the A-arm median. Negative overhead = B is faster."""
    med_a = statistics.median(a_ms)
    diffs = [b - a for a, b in zip(a_ms, b_ms)]
    overhead_pct = 100.0 * statistics.median(diffs) / med_a
    noise_pct = 100.0 * max(iqr(diffs), iqr(a_ms), iqr(b_ms)) / med_a
    if overhead_pct + noise_pct < budget_pct:
        verdict = "pass"  # under budget even pessimistically
    elif overhead_pct - noise_pct > budget_pct:
        verdict = "fail"  # over budget even optimistically
    elif noise_pct <= budget_pct / 2:
        # the floor is well under the budget: the threshold itself resolves
        verdict = "pass" if overhead_pct < budget_pct else "fail"
    else:
        verdict = "inconclusive"  # host too noisy to resolve the budget
    if len(diffs) < 4 and noise_pct > budget_pct / 2:
        # under 4 pairs the range-based floor underestimates the true
        # spread — a stall hitting both windows of one arm can fabricate a
        # confident verdict; only a near-zero floor earns one
        verdict = "inconclusive"
    return overhead_pct, noise_pct, verdict


__all__ = ["abba_verdict", "iqr"]
