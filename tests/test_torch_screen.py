"""The port's bulk screening (``hydragnn_tpu_torch/screen/``) against the JAX
package's planner and config, and against the port's ``run_prediction``, on
the CPU.

- ``plan_screen`` gives the JAX package's blocks (indices, buckets) and
  fingerprint for the same sizes, bucket table and order, reading sizes
  only (no sample is fetched at plan time);
- the ``Screening`` block and the ``HYDRAGNN_SCREEN_*`` flags resolve as
  the JAX package's;
- a screen's ranked scores are ``run_prediction``'s predictions, bit for
  bit; a screen interrupted between blocks and resumed from its sidecar
  gives the uninterrupted top-k (no graph lost or scored twice), and a
  sidecar of another plan is refused; ``prefetch`` 0 and 2 give the same
  result, and the staging thread is joined;
- with a population attached, each graph's variance is the variance of the
  members' own predictions (numpy float32), bit for bit;
- a node score head is refused.
"""

import copy
import json

import numpy as np
import pytest

import torch_port_util as tpu
from hydragnn_tpu.screen import plan_screen as jax_plan_screen
from hydragnn_tpu.screen import screening_config_from as jax_screening_config_from
from hydragnn_tpu_torch.screen import (BulkScreener, ScreeningConfig, plan_fingerprint,
                                       plan_screen, screening_config_defaults,
                                       screening_config_from)
from test_config import CI_CONFIG
from torch_port_util import joined_threads  # noqa: F401  (fixture)


class SizedStore:
    """Samples behind ``sample_sizes`` (as the packed and sharded stores
    answer it) and ``fetch``; counts the samples fetched."""

    def __init__(self, samples):
        self.samples = list(samples)
        self.fetched = 0

    def __len__(self):
        return len(self.samples)

    def sample_sizes(self, indices):
        return np.asarray([(self.samples[int(i)].num_nodes, self.samples[int(i)].num_edges)
                           for i in indices], np.int64)

    def fetch(self, indices):
        self.fetched += len(indices)
        return [self.samples[int(i)] for i in indices]


def _sized_samples(n: int, seed: int):
    from hydragnn_tpu.graphs.graph import GraphSample

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 30))
        e = int(rng.integers(0, 3 * k + 1))
        out.append(GraphSample(x=rng.normal(size=(k, 1)).astype(np.float32),
                               senders=rng.integers(0, k, e), receivers=rng.integers(0, k, e),
                               graph_y=np.zeros(1, np.float32)))
    return out


@pytest.mark.parametrize("bucket_major", [True, False])
def test_plan_equals_jax_blocks_and_fingerprint(bucket_major):
    from hydragnn_tpu.graphs.batching import compute_pad_buckets as jax_buckets
    from hydragnn_tpu_torch.graphs.batching import compute_pad_buckets

    jax_samples = _sized_samples(300, 4)
    samples = tpu.port_samples(jax_samples)
    buckets = compute_pad_buckets(samples, 16, max_buckets=4)
    jbuckets = jax_buckets(jax_samples, 16, max_buckets=4)
    assert [b.as_tuple() for b in buckets] == [b.as_tuple() for b in jbuckets]
    indices = np.random.default_rng(1).permutation(300)[:250]
    ours_store, theirs_store = SizedStore(samples), SizedStore(jax_samples)
    ours = plan_screen(ours_store, indices, buckets, bucket_major=bucket_major)
    theirs = jax_plan_screen(theirs_store, indices, jbuckets, bucket_major=bucket_major)
    assert ours_store.fetched == 0, "planning reads sizes only"
    assert ours.fingerprint == theirs.fingerprint
    assert ours.fingerprint == plan_fingerprint(indices, buckets, bucket_major)
    assert (ours.n_graphs, ours.n_tail_blocks) == (theirs.n_graphs, theirs.n_tail_blocks)
    assert [(b.indices.tolist(), b.pad.as_tuple()) for b in ours.blocks] == \
        [(b.indices.tolist(), b.pad.as_tuple()) for b in theirs.blocks]
    flat = sorted(i for b in ours.blocks for i in b.indices.tolist())
    assert flat == sorted(indices.tolist())  # every graph once


def test_screening_block_and_flags_resolve_as_jax(monkeypatch):
    from hydragnn_tpu.screen import screening_config_defaults as jax_defaults

    assert screening_config_defaults() == jax_defaults()
    cfg = {"Screening": {"topk": 5, "prefetch": 1, "batch_size": 8}}
    assert screening_config_from(cfg) == ScreeningConfig(**vars(jax_screening_config_from(cfg)))
    monkeypatch.setenv("HYDRAGNN_SCREEN_TOPK", "3")
    monkeypatch.setenv("HYDRAGNN_SCREEN_PREFETCH", "0")
    ours = screening_config_from(cfg)
    assert (ours.topk, ours.prefetch) == (3, 0)
    assert vars(ours) == vars(jax_screening_config_from(cfg))
    with pytest.raises(ValueError, match="topk"):
        ScreeningConfig(topk=0).validate()


class _Run:
    """A random-init CI GIN, its augmented config and its test split (the
    samples ``run_prediction`` evaluates), on the CPU."""

    def __init__(self):
        from hydragnn_tpu_torch.config import update_config
        from hydragnn_tpu_torch.datasets import deterministic_graph_data
        from hydragnn_tpu_torch.models import create_model_config
        from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

        self.cfg = copy.deepcopy(CI_CONFIG)
        self.cfg["NeuralNetwork"]["Training"]["batch_size"] = 8
        self.samples = deterministic_graph_data(number_configurations=120, seed=5)
        loaders = dataset_loading_and_splitting(copy.deepcopy(self.cfg),
                                                samples=copy.deepcopy(self.samples))
        self.aug = update_config(copy.deepcopy(self.cfg), *(ld.samples for ld in loaders))
        self.test_loader = loaders[2]
        self.test = list(loaders[2].samples)
        self.model = create_model_config(copy.deepcopy(self.aug), device="cpu", seed=0)
        # the test loader's pad table: a screen composes its blocks as the
        # loader composes its batches (stream order, the same bucket)
        self.buckets = loaders[2].buckets or [loaders[2].pad]

    def screener(self, cfg: ScreeningConfig, pop_state=None):
        from hydragnn_tpu_torch.serve.predictor import Predictor

        predictor = Predictor(self.model, self.aug, device="cpu")
        return BulkScreener(predictor, self.buckets, self.test[0], cfg,
                            pop_state=pop_state)


_RUN = {}


def _run() -> _Run:
    if "run" not in _RUN:
        _RUN["run"] = _Run()
    return _RUN["run"]


def test_screen_scores_equal_run_prediction_and_resume_is_exact(tmp_path, joined_threads):
    """Every graph of the test split screened: the ranked scores are the
    predictions ``run_prediction`` reports for those graphs, bit for bit; an
    interrupted screen resumed from its sidecar gives the same top-k, every
    graph scored once; prefetch 0 gives the same result; a sidecar of
    another plan is refused; warm-up leaves nothing to capture."""
    from hydragnn_tpu_torch import run_prediction

    r = _run()
    n = len(r.test)
    store = SizedStore(r.test)
    full = r.screener(ScreeningConfig(topk=n, prefetch=2))
    full.warm()
    assert full.captures() == 0  # the CPU runs the eager steps
    whole = full.screen(store)
    assert whole.completed and whole.graphs_done == n and len(whole.topk) == n
    _, _, _, preds = run_prediction(copy.deepcopy(r.cfg), r.model,
                                    samples=copy.deepcopy(r.samples), device="cpu")
    order = np.concatenate([c for c, _ in r.test_loader.batch_plan()])
    by_index = {int(i): np.float32(preds[0][k, 0]) for k, i in enumerate(order)}
    for e in whole.topk:
        assert np.float32(e.score) == by_index[e.index], e
        assert e.variance is None and e.trusted
    scores = [e.score for e in whole.topk]
    assert scores == sorted(scores, reverse=True)

    class StopAfter:
        def __init__(self, k):
            self.k, self.calls = k, 0

        @property
        def requested(self):
            self.calls += 1
            return self.calls >= self.k

    topk = 7
    meta = str(tmp_path / "screen_meta.json")
    ref = r.screener(ScreeningConfig(topk=topk, prefetch=0)).screen(store)
    first = r.screener(ScreeningConfig(topk=topk, prefetch=2)).screen(
        store, meta_path=meta, preempt=StopAfter(2))
    assert not first.completed and first.blocks_done == 2
    side = json.load(open(meta))
    assert side["blocks_done"] == 2 and not side["completed"]
    rest = r.screener(ScreeningConfig(topk=topk, prefetch=2)).screen(store, meta_path=meta,
                                                                      resume=True)
    assert rest.completed and rest.resumed_from == 2 and rest.graphs_done == n
    assert rest.topk == ref.topk == whole.topk[:topk]
    assert json.load(open(meta))["completed"]
    with pytest.raises(ValueError, match="fingerprint"):
        r.screener(ScreeningConfig(topk=topk)).screen(store, indices=range(n - 1),
                                                      meta_path=meta, resume=True)


def test_ensemble_variance_is_the_members_variance(joined_threads):
    """A 3-member population attached: each graph's variance equals
    ``np.var`` (float32) of the members' own ``Predictor`` scores on the
    same blocks, bit for bit; ``ensemble_variance_max`` flags, never drops."""
    from hydragnn_tpu_torch.serve.batcher import serving_collate
    from hydragnn_tpu_torch.serve.predictor import Predictor
    from hydragnn_tpu_torch.train.population import create_population_state, member_state

    r = _run()
    pstate = create_population_state(copy.deepcopy(r.aug), 3, seeds=[0, 1, 2], device="cpu")
    scr = r.screener(ScreeningConfig(topk=len(r.test), prefetch=2, ensemble_variance_max=1e-3),
                     pop_state=pstate)
    scr.warm()
    res = scr.screen(SizedStore(r.test))
    members = [Predictor(member_state(pstate, i).model, r.aug, device="cpu") for i in range(3)]
    plan = plan_screen(SizedStore(r.test), range(len(r.test)), scr.buckets)
    want = {}
    for blk in plan.blocks:
        batch = serving_collate([r.test[int(i)] for i in blk.indices], blk.pad)
        mask = batch.graph_mask.numpy() > 0
        per = np.stack([p.answer(batch)[0].numpy()[mask][:, 0] for p in members])
        for i, v in zip(blk.indices, per.var(axis=0).astype(np.float32)):
            want[int(i)] = v
    assert len(res.topk) == len(r.test)
    for e in res.topk:
        assert np.float32(e.variance) == want[e.index]
        assert e.trusted == (e.variance <= 1e-3)
    assert any(not e.trusted for e in res.topk) and any(e.trusted for e in res.topk)


def test_score_head_must_be_a_graph_head():
    from hydragnn_tpu_torch.serve.predictor import Predictor

    r = _run()
    predictor = Predictor(r.model, r.aug, device="cpu")
    with pytest.raises(ValueError, match="score_col"):
        BulkScreener(predictor, r.buckets, r.test[0], ScreeningConfig(score_col=3))
    predictor.cols = [("node", 0, 1)]
    with pytest.raises(ValueError, match="graph head"):
        BulkScreener(predictor, r.buckets, r.test[0], ScreeningConfig())
