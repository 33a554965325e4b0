"""Double-buffered bulk-screening executor over captured predict steps.

Counterpart of ``hydragnn_tpu/screen/engine.py``. Screening a library and
keeping the top-k through the serving tier would pay per-request admission,
coalescing timers and queue locks on every graph, machinery built for
latency a screen does not have. This engine bypasses the request plane: the
planner (``screen.planner``) lays the stream out as full-bucket blocks, and
the executor replays one captured predict graph per bucket
(``Predictor.answer``, ``capture.py``) per block while a background thread
fetches and collates the next block(s): the device computes while the host
stages, and the thread is joined when the screen returns.

Exactness: the scores come from the same ``Predictor`` core and the same
``serving_collate`` as ``run_prediction`` and the serving tier, so for
blocks composed alike the ranked scores are bit-identical to what the
evaluator reports. :meth:`BulkScreener.warm` captures every graph the
screen replays (one per bucket; with a population attached, the ensemble's
predict graph per bucket too) on a dummy batch whose ids are certified
unsorted, so that graph serves every block of its bucket: after it no
capture happens (``capture.no_new_captures`` proves it).

Resume: after every scored block (``Screening.checkpoint_every``) the
engine atomically rewrites a position sidecar (``screen_meta.json``). The
plan is a pure function of its inputs, so an interrupted screen re-plans,
checks the sidecar's plan fingerprint, skips ``blocks_done`` blocks and
goes on: no graph lost, none scored twice, and the final ranked top-k is
bit-identical to an uninterrupted run's.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import NamedTuple, Sequence

import numpy as np

from .. import telemetry as tel
from ..capture import Dispatch, no_new_captures, uncertified
from ..graphs.batching import PadSpec, background_iter
from ..serve.batcher import serving_collate
from ..serve.predictor import Predictor
from .config import ScreeningConfig
from .planner import ScreenPlan, plan_screen

SIDECAR_VERSION = 1


class ScreenEntry(NamedTuple):
    index: int  # global sample index
    score: float  # fp32 value (json round-trips it exactly)
    variance: float | None  # ensemble member variance, None without an ensemble
    trusted: bool  # False when the variance exceeds the configured ceiling


class ScreenResult(NamedTuple):
    topk: list  # list[ScreenEntry], (score desc, index asc)
    completed: bool  # False when interrupted (a stop was requested)
    blocks_done: int  # blocks scored, cumulative across resumes
    graphs_done: int  # graphs scored, cumulative across resumes
    resumed_from: int  # blocks skipped on entry (0 = fresh run)
    elapsed_s: float  # this invocation's wall time
    graphs_per_sec: float  # this invocation's throughput


def _rank(entries: Sequence[ScreenEntry], k: int) -> list:
    """(score desc, index asc): a total order, so the ranking is
    deterministic and a resumed screen reproduces it bit for bit."""
    return sorted(entries, key=lambda t: (-t.score, t.index))[:k]


class BulkScreener:
    """Predictor + bucket table + top-k accumulator.

    ``pop_state``: an optional ``train.population.PopulationState`` on the
    predictor's device. The scores stay the single model's
    (``predictor.model``), bit-identical to ``run_prediction``; the ensemble
    contributes each graph's member VARIANCE (numpy float32 over the
    members' scores, as the JAX engine takes it), and a score whose
    variance exceeds ``cfg.ensemble_variance_max`` is flagged untrusted, not
    dropped."""

    def __init__(self, predictor: Predictor, buckets: Sequence[PadSpec], example,
                 cfg: ScreeningConfig | None = None, pop_state=None):
        self.predictor = predictor
        self.buckets = sorted(buckets, key=lambda p: p.as_tuple())
        self.example = example
        self.cfg = (cfg or ScreeningConfig()).validate()
        self.pop_state = pop_state
        kind, _col, dim = predictor.cols[self.cfg.score_head]
        if kind != "graph":
            raise ValueError(
                f"Screening.score_head={self.cfg.score_head} is a {kind!r} head; screening "
                "ranks per-graph scores, so the score head must be a graph head")
        if self.cfg.score_col >= dim:
            raise ValueError(f"Screening.score_col={self.cfg.score_col} out of range for head "
                             f"{self.cfg.score_head} (dim {dim})")
        self._ensemble = None
        if pop_state is not None:
            from ..train.population import make_population_predict_step

            step = make_population_predict_step(pop_state, predictor.compute_dtype)
            self._ensemble = Dispatch(
                lambda _state, batch: step(batch), "screen ensemble", device=predictor.device,
                ledger={"model": predictor.ledger_model, "kind": "screen_ensemble",
                        "precision": str(predictor.compute_dtype)})
        self._lock = threading.Lock()
        # written by the staging thread, read by the consumer and stats()
        self.prefetch_stats = {"blocks_staged": 0, "stage_s": 0.0}  # guarded-by: _lock

    # -- warm-up ----------------------------------------------------------------

    def _warm_batch(self, pad: PadSpec):
        """The bucket's dummy batch with no id array certified sorted: the
        graph captured on it sorts the ids itself and so serves every block
        of the bucket (a stable sort leaves sorted ids in place: the bits
        of a certified block's graph)."""
        from ..serve.server import _dummy_sample

        return uncertified(serving_collate([_dummy_sample(self.example)], pad))

    def warm(self, verify: bool = True) -> dict:
        """Capture the predict graph of every bucket (and the ensemble's,
        with a population) on the card; with ``verify``, replay each once
        under ``capture.no_new_captures``. Returns the seconds per bucket.
        On the CPU the eager steps run and nothing is captured."""
        report = {}
        for pad in self.buckets:
            batch = self._warm_batch(pad)
            t0 = time.perf_counter()
            self.predictor.answer(batch)
            if self._ensemble is not None:
                self._ensemble(None, batch)
            report[repr(pad)] = round(time.perf_counter() - t0, 4)
        if verify:
            with no_new_captures("screening warm-up verify"):
                for pad in self.buckets:
                    batch = self._warm_batch(pad)
                    self.predictor.answer(batch)
                    if self._ensemble is not None:
                        self._ensemble(None, batch)
        tel.ledger.maybe_save()
        return report

    def captures(self) -> int:
        """Graphs captured for this screener (the predictor's and the
        ensemble's)."""
        own = self._ensemble.graphs.captures if self._ensemble is not None else 0
        return self.predictor.captures() + own

    # -- sidecar (exact-resume position record) -----------------------------------

    @staticmethod
    def _read_sidecar(path: str) -> dict | None:
        try:
            with open(path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    @staticmethod
    def _write_sidecar(path: str, obj: dict) -> None:
        # atomic replace: a kill mid-write leaves the previous sidecar whole
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)

    # -- the screen ----------------------------------------------------------------

    @staticmethod
    def _fetch(store, indices: np.ndarray, bulk: bool) -> list:
        if bulk and hasattr(store, "fetch_many"):
            # the store's cache-bypassing bulk read (datasets.sharded)
            return store.fetch_many(indices)
        if hasattr(store, "fetch"):
            return store.fetch(indices)
        return [store[int(i)] for i in indices]

    def _scores(self, batch) -> np.ndarray:
        out = self.predictor.answer(batch)
        mask = batch.graph_mask.cpu().numpy() > 0
        head = out[self.cfg.score_head].cpu().numpy()
        return head[mask][:, self.cfg.score_col].astype(np.float32)

    def _variances(self, batch) -> np.ndarray | None:
        if self._ensemble is None:
            return None
        out = self._ensemble(None, batch)
        head = out[self.cfg.score_head].cpu().numpy()  # [M, G, dim]
        mask = batch.graph_mask.cpu().numpy() > 0
        return head[:, mask, self.cfg.score_col].var(axis=0).astype(np.float32)

    def screen(self, store, indices=None, *, meta_path: str | None = None, resume: bool = False,
               preempt=None, bulk: bool = True) -> ScreenResult:
        """Score ``indices`` of ``store`` (default: all of it); return the
        ranked top-k.

        ``meta_path``: where the resume sidecar lives (None: no position
        record). ``resume``: continue from that sidecar (a fresh start when
        there is none; a sidecar of another plan raises). ``preempt``:
        anything with a ``requested`` property or method
        (``resilience.PreemptionHandler``), checked between blocks; when it
        fires the sidecar is written and the result has ``completed``
        False. ``bulk=False`` fetches through ``fetch`` (or indexing)."""
        cfg = self.cfg
        if indices is None:
            indices = range(len(store))
        plan = plan_screen(store, indices, self.buckets, bucket_major=cfg.bucket_major)
        entries: list = []
        start_block = 0
        graphs_done = 0
        if resume and meta_path:
            side = self._read_sidecar(meta_path)
            if side is not None:
                if side.get("fingerprint") != plan.fingerprint:
                    raise ValueError(
                        "screen resume refused: sidecar plan fingerprint "
                        f"{side.get('fingerprint')!r} does not match the recomputed plan "
                        f"{plan.fingerprint!r}: the store, the index set or the bucket table "
                        "changed since the interrupted run")
                start_block = int(side["blocks_done"])
                graphs_done = int(side["graphs_done"])
                entries = [ScreenEntry(int(i), float(s), None if v is None else float(v),
                                       bool(tr)) for i, s, v, tr in side["topk"]]
                tel.emit("screen_resume", blocks_done=start_block, graphs_done=graphs_done,
                         fingerprint=plan.fingerprint)

        def sidecar_obj(completed: bool, blocks_done: int) -> dict:
            return {"version": SIDECAR_VERSION, "fingerprint": plan.fingerprint,
                    "blocks_done": blocks_done, "graphs_done": graphs_done,
                    "completed": completed,
                    "topk": [[e.index, e.score, e.variance, e.trusted] for e in entries]}

        def produce():
            for bi in range(start_block, len(plan.blocks)):
                blk = plan.blocks[bi]
                t0 = time.perf_counter()
                batch = serving_collate(self._fetch(store, blk.indices, bulk), blk.pad)
                dt = time.perf_counter() - t0
                with self._lock:
                    self.prefetch_stats["blocks_staged"] += 1
                    self.prefetch_stats["stage_s"] += dt
                yield bi, blk, batch

        # prefetch > 0: fetch + collate in a worker thread up to ``prefetch``
        # blocks ahead of the device; 0: synchronous (identical scores)
        it = background_iter(produce(), depth=cfg.prefetch) if cfg.prefetch > 0 else produce()
        var_max = cfg.ensemble_variance_max
        blocks_done = start_block
        graphs_this_run = 0
        interrupted = False
        t_start = time.perf_counter()
        try:
            for bi, blk, batch in it:
                t0 = time.perf_counter()
                scores = self._scores(batch)
                variances = self._variances(batch)
                for j, idx in enumerate(blk.indices):
                    var = None if variances is None else float(variances[j])
                    trusted = not (var is not None and var_max > 0 and var > var_max)
                    entries.append(ScreenEntry(int(idx), float(scores[j]), var, trusted))
                entries = _rank(entries, cfg.topk)
                graphs_done += len(blk.indices)
                graphs_this_run += len(blk.indices)
                blocks_done = bi + 1
                tel.emit("screen_block", block=bi, bucket=list(blk.pad.as_tuple()),
                         n_graphs=len(blk.indices), ms=round((time.perf_counter() - t0) * 1e3, 3))
                if meta_path and (blocks_done == len(plan.blocks)
                                  or (blocks_done - start_block) % cfg.checkpoint_every == 0):
                    self._write_sidecar(meta_path, sidecar_obj(blocks_done == len(plan.blocks),
                                                               blocks_done))
                if preempt is not None and blocks_done < len(plan.blocks):
                    req = preempt.requested
                    if callable(req):
                        req = req()
                    if req:
                        interrupted = True
                        break
        finally:
            if hasattr(it, "close"):
                it.close()  # stops the staging thread and joins it
        elapsed = time.perf_counter() - t_start
        if interrupted and meta_path:
            # a stop between two sidecar writes still persists the position
            self._write_sidecar(meta_path, sidecar_obj(False, blocks_done))
        return ScreenResult(
            topk=list(entries), completed=blocks_done >= len(plan.blocks),
            blocks_done=blocks_done, graphs_done=graphs_done, resumed_from=start_block,
            elapsed_s=elapsed,
            graphs_per_sec=round(graphs_this_run / elapsed, 3) if elapsed > 0 else 0.0)


__all__ = ["BulkScreener", "ScreenEntry", "ScreenPlan", "ScreenResult"]
