"""The port's serving tier and batch evaluator (``hydragnn_tpu_torch.serve``,
``run_prediction``) on the CPU: served answers bit-equal to the port's own
``run_prediction`` (the same predict core on the same padded batches, fp32),
the port's ``run_prediction`` against the JAX package's from the same
converted state, typed admission errors, and the card-by-default entry
points.
"""

import copy
import threading

import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models.create import init_model
from hydragnn_tpu.preprocess.load_data import (
    dataset_loading_and_splitting as jax_loading,
)
from hydragnn_tpu.run_prediction import run_prediction as jax_run_prediction
from hydragnn_tpu.train.step import TrainState
from hydragnn_tpu_torch import run_prediction
from hydragnn_tpu_torch.config import update_config
from hydragnn_tpu_torch.graphs.graph import GraphSample
from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
from hydragnn_tpu_torch.serve import (
    DeadlineExceededError,
    IncompatibleSampleError,
    MicroBatcher,
    OversizeError,
    PredictionServer,
    Predictor,
    QueueFullError,
    ServerClosedError,
    ServingConfig,
    UnknownModelError,
)
from test_config import CI_CONFIG


def _multihead_config():
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Variables_of_interest"] = {
        "input_node_features": [0],
        "output_names": ["sum", "x"],
        "output_index": [0, 1],
        "type": ["graph", "node"],
        "denormalize_output": False,
    }
    cfg["NeuralNetwork"]["Architecture"]["task_weights"] = [1.0, 1.0]
    cfg["NeuralNetwork"]["Architecture"]["output_heads"]["node"] = {
        "num_headlayers": 2, "dim_headlayers": [8, 8], "type": "mlp"}
    return cfg


@pytest.fixture(scope="module")
def served():
    """(raw config, port augmented config, port model, JAX model, JAX state,
    the JAX samples as generated)."""
    import jax
    import jax.numpy as jnp

    cfg = _multihead_config()
    samples = deterministic_graph_data(number_configurations=60, seed=7)
    loaders = jax_loading(copy.deepcopy(cfg), samples=tpu.jax_samples_copy(samples))
    jaug = jax_update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
    jmodel = jax_create_model_config(jaug)
    variables = init_model(jmodel, next(iter(loaders[0])))
    variables = tpu.random_batch_stats(tpu.jitter_params(variables, seed=4), seed=5)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=None, step=jnp.zeros((), jnp.int32))
    ploaders = dataset_loading_and_splitting(copy.deepcopy(cfg),
                                             samples=tpu.port_samples(samples))
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in ploaders))
    model = tpu.port_model_from_jax(aug, jax.tree.map(np.asarray, variables))
    return cfg, aug, model, jmodel, state, samples


def test_served_bitmatch_run_prediction(served):
    """Serve the test split grouped as ``run_prediction``'s loader batches
    it; every head must equal ``run_prediction``'s predictions bit for bit
    (fp32, CPU: the same predict core on the same padded batches)."""
    cfg, aug, model, _, _, samples = served
    ps = tpu.port_samples(samples)
    _, _, trues, preds = run_prediction(copy.deepcopy(cfg), model, samples=ps, device="cpu")
    _, _, test_loader = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=ps)
    server = PredictionServer(ServingConfig(flush_ms=250.0), device="cpu")
    server.add_model("gin", model, aug, samples=test_loader.samples,
                     buckets=[test_loader.pad])
    report = server.warmup()
    assert set(report["gin"]) == {repr(test_loader.pad)}
    server.start()
    try:
        served_heads = [[] for _ in preds]
        for chunk, _pad in test_loader.batch_plan():
            futs = [server.submit("gin", test_loader.samples[i]) for i in chunk]
            results = [f.result(timeout=60.0) for f in futs]
            assert {r["batch_graphs"] for r in results} == {len(chunk)}
            assert [r["slot"] for r in results] == list(range(len(chunk)))
            for ihead in range(len(preds)):
                served_heads[ihead].extend(np.atleast_1d(r["heads"][ihead]) for r in results)
        for ihead, want in enumerate(preds):
            got = np.concatenate([a.reshape(-1, want.shape[1]) for a in served_heads[ihead]])
            assert np.array_equal(got, want), f"head {ihead}: served != run_prediction"
        stats = server.stats()["gin"]
        assert stats["served"] == sum(len(c) for c, _ in test_loader.batch_plan())
        assert stats["failed"] == 0 and stats["warmed"]
    finally:
        server.stop()


def test_run_prediction_matches_jax(served):
    """The port's ``run_prediction`` against the JAX package's from the same
    converted state: the same test split and targets (equal), predictions
    within fp32 reordering (rtol 2e-5 / atol 1e-5), losses within 1e-4."""
    cfg, _, model, jmodel, state, samples = served
    err_j, tasks_j, trues_j, preds_j = jax_run_prediction(
        copy.deepcopy(cfg), state, jmodel, samples=tpu.jax_samples_copy(samples))
    err_p, tasks_p, trues_p, preds_p = run_prediction(
        copy.deepcopy(cfg), model, samples=tpu.port_samples(samples), device="cpu")
    for tj, tp in zip(trues_j, trues_p):
        assert np.array_equal(np.asarray(tj), tp)
    for pj, pp in zip(preds_j, preds_p):
        np.testing.assert_allclose(pp, np.asarray(pj), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(tasks_p, tasks_j, rtol=1e-4)
    np.testing.assert_allclose(err_p, err_j, rtol=1e-4)


def test_denormalized_run_prediction_matches_jax(served):
    cfg, _, model, jmodel, state, samples = served
    cfg = copy.deepcopy(cfg)
    cfg["NeuralNetwork"]["Variables_of_interest"]["denormalize_output"] = True
    _, _, trues_j, preds_j = jax_run_prediction(
        copy.deepcopy(cfg), state, jmodel, samples=tpu.jax_samples_copy(samples))
    _, _, trues_p, preds_p = run_prediction(
        copy.deepcopy(cfg), model, samples=tpu.port_samples(samples), device="cpu")
    for tj, tp, pj, pp in zip(trues_j, trues_p, preds_j, preds_p):
        np.testing.assert_allclose(tp, np.asarray(tj), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pp, np.asarray(pj), rtol=2e-5, atol=1e-4)


def _boot(served, **cfg_kw):
    _, aug, model, _, _, samples = served
    server = PredictionServer(ServingConfig(**cfg_kw), device="cpu")
    ps = tpu.port_samples(samples)
    server.add_model("gin", model, aug, samples=ps, batch_size=8)
    return server, ps


def test_typed_admission_errors(served):
    server, ps = _boot(served, flush_ms=1.0)
    with pytest.raises(ServerClosedError, match="not started"):
        server.submit("gin", ps[0])
    with pytest.raises(ValueError, match="already registered"):
        server.add_model("gin", served[2], served[1], samples=ps)
    server.start()
    try:
        with pytest.raises(UnknownModelError):
            server.submit("nope", ps[0])
        bad = GraphSample(x=np.zeros((3, 2), np.float32))  # two input features
        with pytest.raises(IncompatibleSampleError):
            server.submit("gin", bad)
        heads = server.predict("gin", ps[:5])
        assert len(heads) == 5 and all(np.isfinite(h[0]).all() for h in heads)
    finally:
        server.stop()
    with pytest.raises(ServerClosedError):
        server.submit("gin", ps[0])
    assert server.stats()["gin"]["shed"] == 1  # the incompatible sample


def test_queue_full_deadline_and_oversize_shed(served):
    """With the dispatcher held inside a batch, the bounded queue fills and
    the next request is shed with ``QueueFullError``; an expired request
    fails with ``DeadlineExceededError`` and an oversized one with
    ``OversizeError``, while the live requests around them are served."""
    server, ps = _boot(served, queue_depth=2, flush_ms=0.0)
    ep = server._models["gin"]
    entered, release = threading.Event(), threading.Event()
    real_serve = ep.serve_batch

    def held(members, pad):
        entered.set()
        release.wait(timeout=30)
        real_serve(members, pad)

    ep.serve_batch = held
    server.start()
    try:
        first = server.submit("gin", ps[0])
        assert entered.wait(timeout=30)
        expiring = server.submit("gin", ps[1], deadline_ms=1.0)
        big = GraphSample(x=np.zeros((ep.buckets[-1].n_node + 5, 1), np.float32))
        oversize = server.submit("gin", big)
        with pytest.raises(QueueFullError):
            server.submit("gin", ps[2])
        threading.Event().wait(0.05)  # let the 1 ms deadline pass
        release.set()
        assert first.result(timeout=30)["heads"]
        with pytest.raises(DeadlineExceededError):
            expiring.result(timeout=30)
        with pytest.raises(OversizeError):
            oversize.result(timeout=30)
        stats = server.stats()["gin"]
        assert stats["shed"] == 1 and stats["shed_deadline"] == 1
        assert stats["shed_oversize"] == 1 and stats["served"] == 1
    finally:
        release.set()
        server.stop()


def test_entry_points_default_to_the_card(served):
    """Without ``device="cpu"`` every entry point asks for the card, and with
    no card present it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hydragnn_tpu_torch.models import create_model_config

    cfg, aug, model, _, _, samples = served
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictionServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model, aug)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model_config(copy.deepcopy(aug))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_prediction(copy.deepcopy(cfg), model, samples=tpu.port_samples(samples))
    assert next(model.parameters()).device.type == "cpu"


class _ScriptedQueue:
    """A request queue that hands out its requests and then records each
    wait the batcher asks for (returning at once, as a timeout would)."""

    def __init__(self, requests):
        self.requests = list(requests)
        self.waits = []

    def get(self, timeout=None):
        if self.requests:
            return self.requests.pop(0)
        self.waits.append(timeout)
        return None

    def push_back(self, req):
        self.requests.insert(0, req)


@pytest.mark.parametrize("deadline_ms", [150.0, None])
def test_flush_window_clamped_to_deadline(monkeypatch, deadline_ms):
    """A lone request whose deadline is shorter than the flush window closes
    its batch at the deadline less the dispatch margin, not at the end of
    the 2 s window (``serve/batcher.py``); without a deadline the batch
    waits the whole window. The batcher's clock is pinned and the wait it
    asks the queue for is read off, so no request is timed against the
    wall clock (the JAX package's own test times one, and fails when the
    host is slow)."""
    import time
    import types

    from hydragnn_tpu_torch.graphs.batching import PadSpec
    from hydragnn_tpu_torch.serve import batcher as batcher_mod
    from hydragnn_tpu_torch.serve.admission import Request

    now = time.monotonic()
    monkeypatch.setattr(batcher_mod, "time", types.SimpleNamespace(monotonic=lambda: now))
    sample = GraphSample(x=np.zeros((5, 1), np.float32), graph_y=np.zeros(1, np.float32))
    deadline = None if deadline_ms is None else now + deadline_ms / 1e3
    queue = _ScriptedQueue([Request(sample=sample, deadline=deadline)])
    pad = PadSpec(n_node=64, n_edge=256, n_graph=9, node_cap=16)
    batcher = MicroBatcher(queue, [pad], flush_s=2.0)
    members, got_pad = batcher.next_batch(block=False)
    assert len(members) == 1 and got_pad == pad
    window = 2.0 if deadline is None else deadline_ms / 1e3 - batcher_mod._DISPATCH_MARGIN_S
    assert queue.waits == [pytest.approx(window, abs=1e-9)]


def test_warm_batch_certifies_what_traffic_certifies(served):
    """The warm-up's dummy batch of each bucket carries the sortedness
    certificates of a batch of real samples in that bucket, so the graph
    captured on it serves them and skips the argsorts their eager step
    skips; a one-node dummy alone would certify every id array sorted."""
    from hydragnn_tpu_torch import capture
    from hydragnn_tpu_torch.graphs.batching import pick_bucket
    from hydragnn_tpu_torch.serve.batcher import serving_collate
    from hydragnn_tpu_torch.serve.server import _dummy_sample

    server, ps = _boot(served, flush_ms=1.0)
    ep = server._models["gin"]
    assert any(not np.all(np.diff(s.senders) >= 0) for s in ps), "need unsorted senders"
    names = ("recv_sorted", "send_sorted", "batch_sorted")
    for i, k in enumerate((1, 2, 3, 5, 8)):
        group = ps[8 * i:8 * i + k]
        pad = pick_bucket(ep.buckets, sum(s.num_nodes for s in group),
                          sum(s.num_edges for s in group), n_graphs=len(group))
        real = serving_collate(group, pad)
        warm = ep.warm_batch(pad)
        assert [getattr(warm.meta, n) for n in names] == [getattr(real.meta, n) for n in names]
        assert capture.signature(warm) == capture.signature(real)
    dummy = serving_collate([_dummy_sample(ps[0])], ep.buckets[0])
    assert all(getattr(dummy.meta, n) for n in names)
    assert not all(getattr(ep.warm_batch(ep.buckets[0]).meta, n) for n in names)
