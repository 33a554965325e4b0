"""The port's serving fleet (``hydragnn_tpu_torch.serve.fleet``,
``utils.wire``, ``serve.traffic``) against the JAX package's on the CPU.

The wire and the cache must be the JAX package's byte for byte: a frame of
the same sample (and a request frame as a ``RoundTripper`` puts it on the
socket, recorded by a raw listener), and ``answer_key`` of the same sample,
model and quant flag. The behaviour is ``tests/test_fleet.py``'s and
``tests/test_fleet_autoscale.py``'s in the port's terms, over ONE warm
port ``PredictionServer`` (the CI GIN on the CPU) shared by every non-slow
test behind fresh wire front ends, so the module adds one warm-up and
seconds of traffic. A second replica is a second ``ReplicaHost`` over the
same server: failover and rollouts need no second warm-up. The subprocess
replica (a ``python -m`` boot from checkpoint paths on the CPU) takes ~6 s
and is not slow-marked; the same boot also runs in process
(``replica._build_server``).

Tolerances: none. Answers through the router equal the direct server's bit
for bit (fp32, the CPU); cache hits equal replica compute byte for byte.
"""

import copy
import socket
import threading
import time
import warnings

import numpy as np
import pytest

import torch_port_util as tpu
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.serve import traffic as jax_traffic
from hydragnn_tpu.serve.fleet import cache as jax_cache
from hydragnn_tpu.serve.fleet import config as jax_fleet_config
from hydragnn_tpu.utils import wire as jwire
from hydragnn_tpu.utils.retry import RetryPolicy as JaxRetryPolicy
from hydragnn_tpu_torch.config import update_config
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
from hydragnn_tpu_torch.serve import (
    CanaryMismatchError,
    DeadlineExceededError,
    FleetConfig,
    FleetRouter,
    PredictionServer,
    QueueFullError,
    ReplicaHost,
    ServerClosedError,
    ServingConfig,
    UnknownModelError,
    blue_green_rollout,
    fleet_config_defaults,
    mixed_priority_plan,
    run_traffic,
    zipf_duplicate_order,
)
from hydragnn_tpu_torch.serve.fleet import (
    AutoscalerConfig,
    RolloutConfig,
    autoscaler_config_defaults,
    rollout_config_defaults,
)
from hydragnn_tpu_torch.serve.fleet.autoscaler import (
    HOLD,
    SCALE_DOWN,
    SCALE_UP,
    Autoscaler,
    AutoscalerState,
    Signals,
    decide,
)
from hydragnn_tpu_torch.serve.fleet.cache import AnswerCache, answer_key, canonical_sample_bytes
from hydragnn_tpu_torch.serve.fleet.replica import (
    ReplicaBootError,
    _build_server,
    _read_ready_file,
    spawn_replica,
    write_samples_file,
)
from hydragnn_tpu_torch.utils import wire
from hydragnn_tpu_torch.utils.retry import RetryPolicy
from test_config import CI_CONFIG


@pytest.fixture(scope="module")
def warm_server():
    """ONE warm single-model port server (the CI GIN, CPU) shared by every
    non-slow test; both packages' samples."""
    jsamples = deterministic_graph_data(number_configurations=40, seed=7)
    samples = tpu.port_samples(jsamples)
    cfg = copy.deepcopy(CI_CONFIG)
    tl, vl, sl = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=samples)
    aug = update_config(copy.deepcopy(cfg), tl.samples, vl.samples, sl.samples)
    model = create_model_config(aug, device="cpu")
    server = PredictionServer(ServingConfig(flush_ms=2.0), device="cpu")
    server.add_model("gin", model, aug, samples=samples, batch_size=8)
    server.warmup()
    server.start()
    yield {"server": server, "samples": samples, "jsamples": jsamples, "aug": aug,
           "model": model}
    server.stop()


def _heads(result):
    return [np.asarray(a) for a in result["heads"]]


def _router(*hosts, **cfg):
    cfg.setdefault("peer_timeout", 5.0)
    cfg.setdefault("cache_bytes", 1 << 22)
    router = FleetRouter(cfg)
    for h in hosts:
        router.attach("127.0.0.1", h.port)
    return router.start()


# -- byte-equal to the JAX package: the wire and the cache keys ----------------


def _molecule_samples():
    """Samples with every wire extra: GPS's encodings, DimeNet's triplets."""
    from conftest import random_molecule_samples

    jax_s = random_molecule_samples(3, seed=5)
    rng = np.random.default_rng(0)
    for s in jax_s:
        s.extras["pe"] = rng.normal(size=(s.num_nodes, 4)).astype(np.float32)
        s.extras["rel_pe"] = rng.normal(size=(s.num_edges, 4)).astype(np.float32)
        s.extras["idx_kj"] = np.arange(5, dtype=np.int32)
        s.extras["idx_ji"] = np.arange(5, dtype=np.int32)[::-1].copy()
    return jax_s


def test_wire_frames_equal_jax(warm_server):
    """Sample frames, request frames (samples beside routing fields),
    pongs and error records: the same bytes in both packages; a port frame
    decodes to the sample it encodes."""
    jsamples = warm_server["jsamples"][:4] + _molecule_samples()
    samples = tpu.port_samples(jsamples)
    for js, ps in zip(jsamples, samples):
        assert wire.pack_arrays(wire.sample_to_arrays(ps)) == \
            jwire.pack_arrays(jwire.sample_to_arrays(js))
    assert wire.encode_samples(samples) == jwire.encode_samples(jsamples)
    fields = {"predict": np.asarray(1, np.int64), "model": wire.text_field("gin"),
              **wire.sample_fields(samples[-1:])}
    jfields = {"predict": np.asarray(1, np.int64), "model": jwire.text_field("gin"),
               **jwire.sample_fields(jsamples[-1:])}
    assert wire.pack_arrays(fields) == jwire.pack_arrays(jfields)
    assert wire.pong_frame(ready=np.asarray(1, np.int64), models=wire.text_field("a,b")) == \
        jwire.pong_frame(ready=np.asarray(1, np.int64), models=jwire.text_field("a,b"))
    assert wire.error_frame(-3, "boom") == jwire.error_frame(-3, "boom")
    back = wire.samples_from_frame(wire.unpack_arrays(wire.encode_samples(samples)))
    for a, b in zip(samples, back):
        assert canonical_sample_bytes(a) == canonical_sample_bytes(b)
        assert b.x.flags.writeable
    with pytest.raises(ValueError, match="magic"):
        wire.unpack_arrays(b"XXXX" + wire.encode_samples(samples)[4:])
    with pytest.raises(ValueError):
        wire.unpack_arrays(wire.encode_samples(samples)[:40])


def _close_listener(srv: socket.socket, thread: threading.Thread) -> None:
    """Close a helper peer's listening socket and wait for its accept loop:
    closing alone does not wake an ``accept`` blocked in another thread,
    a shutdown does."""
    try:
        srv.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.close()
    thread.join(5.0)
    assert not thread.is_alive(), "helper peer's accept loop did not stop"


class _Recorder:
    """A raw TCP peer that records every request frame's bytes and answers
    each with a pong."""

    def __init__(self):
        self.frames = []
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(4)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                self.frames.append(wire.recv_msg(conn))
                wire.send_msg(conn, wire.pong_frame(ready=np.asarray(1, np.int64)))
        except (OSError, ConnectionError, ValueError):
            conn.close()

    def close(self):
        _close_listener(self._srv, self._thread)


def test_round_tripper_request_bytes_equal_jax(warm_server):
    """A predict request with an auth token, as each package's
    ``RoundTripper`` puts it on the socket (no request_id is in scope, so
    neither package's trace-context hook adds a field): the same bytes."""
    jsample = warm_server["jsamples"][3]
    sample = tpu.port_samples([jsample])[0]
    peer = _Recorder()
    try:
        ours = wire.RoundTripper(5.0, auth_token="tok")
        theirs = jwire.RoundTripper(5.0, auth_token="tok")
        z = ours.round_trip("k", "127.0.0.1", peer.port, policy=RetryPolicy(attempts=1),
                            predict=np.asarray(1, np.int64), model=wire.text_field("gin"),
                            **wire.sample_fields([sample]))
        theirs.round_trip("k", "127.0.0.1", peer.port, policy=JaxRetryPolicy(attempts=1),
                          predict=np.asarray(1, np.int64), model=jwire.text_field("gin"),
                          **jwire.sample_fields([jsample]))
        ours.close()
        theirs.close()
    finally:
        peer.close()
    assert int(z["pong"]) == 1
    assert len(peer.frames) == 2 and peer.frames[0] == peer.frames[1]
    assert "token" in wire.unpack_arrays(peer.frames[0])


def test_answer_keys_equal_jax(warm_server):
    """Content-addressed keys of the same samples, models and quant flags:
    the JAX package's, digit for digit."""
    jsamples = warm_server["jsamples"][:6] + _molecule_samples()
    samples = tpu.port_samples(jsamples)
    for js, ps in zip(jsamples, samples):
        assert canonical_sample_bytes(ps) == jax_cache.canonical_sample_bytes(js)
        for model in ("gin", "qm9_mace"):
            for quant in (False, True):
                assert answer_key(ps, model, quant) == jax_cache.answer_key(js, model, quant)


def test_cache_key_separates_content_model_and_quant(warm_server):
    samples = warm_server["samples"]
    a, b = samples[0], samples[1]
    assert canonical_sample_bytes(a) == canonical_sample_bytes(a)
    assert canonical_sample_bytes(a) != canonical_sample_bytes(b)
    assert answer_key(a, "m1") == answer_key(a, "m1")
    assert answer_key(a, "m1") != answer_key(a, "m2")
    assert answer_key(a, "m1") != answer_key(a, "m1", quantized=True)
    assert answer_key(a, "m1") != answer_key(b, "m1")


def test_answer_cache_lru_byte_budget_and_isolation():
    heads = lambda v: [np.full((4, 4), v, np.float32)]  # noqa: E731 (64 bytes each)
    cache = AnswerCache(budget_bytes=3 * (64 + 2))
    for key, v in (("k1", 1.0), ("k2", 2.0), ("k3", 3.0)):
        assert cache.put(key, heads(v))
    assert len(cache) == 3
    assert cache.get("k1") is not None  # k2 is now the coldest
    assert cache.put("k4", heads(4.0))
    assert cache.get("k2") is None
    assert cache.get("k1") is not None and cache.get("k4") is not None
    assert cache.stats()["evictions"] == 1 and cache.bytes <= cache.budget_bytes
    got = cache.get("k3")
    got[0][:] = -99.0  # a caller's mutation never reaches later hits
    assert np.array_equal(cache.get("k3")[0], np.full((4, 4), 3.0, np.float32))
    assert not cache.put("big", [np.zeros((64, 64), np.float32)])
    assert cache.stats()["oversize_skips"] == 1
    off = AnswerCache(0)
    assert not off.put("k", heads(1.0)) and off.get("k") is None


# -- one replica behind the router --------------------------------------------


def test_fleet_single_replica_cache_canary(warm_server):
    """A router over one wire replica answers bit-identically to the direct
    in-process server; a duplicate graph is a cache hit, byte-identical to
    replica compute, at no replica cost; the replica's captures since ready
    read 0; routing errors are typed."""
    server, samples = warm_server["server"], warm_server["samples"]
    host = ReplicaHost(server)
    router = _router(host)
    try:
        probe = samples[:5]
        direct = [_heads(server.submit("gin", s).result(timeout=30)) for s in probe]
        routed = [_heads(router.submit("gin", s).result(timeout=30)) for s in probe]
        for d, r in zip(direct, routed):
            assert len(d) == len(r) >= 1
            for a, b in zip(d, r):
                assert np.array_equal(a, b)
        before = router.replica_stats(0)["served"]
        hit = router.submit("gin", probe[0]).result(timeout=30)
        assert hit["cached"] is True
        for a, b in zip(routed[0], _heads(hit)):
            assert a.tobytes() == b.tobytes() and a.dtype == b.dtype
        assert router.replica_stats(0)["served"] == before
        st = router.stats()
        assert st["cache_hits"] == 1
        assert st["cache"]["hits"] == 1 and st["cache"]["entries"] == 5
        assert router.replica_stats(0)["steady_captures"] == 0
        with pytest.raises(UnknownModelError):
            router.submit("nope", probe[0])
        with pytest.raises(ValueError, match="priority"):
            router.submit("gin", probe[0], priority="vip")
    finally:
        router.stop()
        host.close()
    with pytest.raises(ServerClosedError):
        router.submit("gin", samples[0])


def test_replica_answers_unknown_ops_and_sheds_typed(warm_server):
    """An op the replica does not serve (the sharded store's ``sizes``) is an
    ``n=-3`` record naming it; an incompatible sample is a typed ``n=-4``
    shed. (The JAX replica's ``metrics`` op is served since the telemetry
    plane is ported: ``tests/test_torch_telemetry.py``.)"""
    server, samples = warm_server["server"], warm_server["samples"]
    host = ReplicaHost(server)
    rt = wire.RoundTripper(5.0)
    try:
        z = rt.round_trip("r", "127.0.0.1", host.port, policy=RetryPolicy(attempts=1),
                          sizes=np.asarray(1, np.int64))
        assert int(z["n"]) == -3 and "unknown fleet op" in wire.frame_detail(z)
        bad = copy.deepcopy(samples[0])
        bad.x = np.concatenate([bad.x, bad.x], axis=1)
        z = rt.round_trip("r", "127.0.0.1", host.port, policy=RetryPolicy(attempts=1),
                          predict=np.asarray(1, np.int64), model=wire.text_field("gin"),
                          **wire.sample_fields([bad]))
        assert int(z["n"]) == -4
        assert wire.field_text(z["etype"]) == "IncompatibleSampleError"
    finally:
        rt.close()
        host.close()


# -- admission, shedding, failover --------------------------------------------


def test_per_class_shedding_order_and_deadline_shed(warm_server):
    """With the replica stalled, best-effort (budget 2) sheds first with a
    typed QueueFullError naming its class while interactive still admits;
    a deadline shorter than the stall sheds typed at dequeue; the queue
    drains once the stall lifts."""
    server, samples = warm_server["server"], warm_server["samples"]
    host = ReplicaHost(server)
    router = _router(host, budget_best_effort=2, budget_batch=4, budget_interactive=64,
                     inflight_per_replica=1, cache_bytes=0)
    try:
        host.set_delay(0.25)
        futs = [router.submit("gin", samples[0], priority="batch")]
        time.sleep(0.05)  # dispatched: the replica is stalled
        futs.append(router.submit("gin", samples[1], priority="best_effort"))
        futs.append(router.submit("gin", samples[2], priority="best_effort"))
        with pytest.raises(QueueFullError, match="best_effort"):
            router.submit("gin", samples[3], priority="best_effort")
        futs.append(router.submit("gin", samples[4], priority="interactive"))
        doomed = router.submit("gin", samples[5], priority="interactive", deadline_ms=40.0)
        with pytest.raises(DeadlineExceededError):
            doomed.result(timeout=10)
        host.set_delay(0.0)
        for f in futs:
            assert f.result(timeout=30)["heads"]
        st = router.stats()
        assert st["shed_best_effort"] == 1 and st["shed_deadline"] >= 1 and st["shed"] >= 2
    finally:
        host.set_delay(0.0)
        router.stop()
        host.close()


def test_dispatcher_no_priority_inversion_on_slot_wait(warm_server):
    """With the one slot stalled, an interactive request submitted after a
    queued best-effort one dispatches first when the slot frees."""
    server, samples = warm_server["server"], warm_server["samples"]
    host = ReplicaHost(server)
    router = _router(host, inflight_per_replica=1, cache_bytes=0)
    try:
        host.set_delay(0.25)
        f_batch = router.submit("gin", samples[0], priority="batch")
        time.sleep(0.05)
        f_be = router.submit("gin", samples[1], priority="best_effort")
        time.sleep(0.05)
        f_int = router.submit("gin", samples[2], priority="interactive")
        assert f_int.result(timeout=10)["heads"]
        assert not f_be.done()
        host.set_delay(0.0)
        assert f_be.result(timeout=10)["heads"] and f_batch.result(timeout=10)["heads"]
    finally:
        host.set_delay(0.0)
        router.stop()
        host.close()


def test_pick_waits_for_saturated_healthy_replica_not_dead_one():
    from hydragnn_tpu_torch.serve.fleet.router import _Replica

    router = FleetRouter({"inflight_per_replica": 2})
    router._replicas = [
        _Replica(rank=0, host="h0", port=1, models=("gin",), quantized={}),
        _Replica(rank=1, host="h1", port=2, models=("gin",), quantized={}),
    ]
    router._health.bump(0)  # rank 0 quarantined
    router._replicas[1].inflight = 2  # rank 1 healthy but saturated
    with router._work:
        assert router._pick_locked("gin") is None
        router._replicas[1].inflight = 1
        assert router._pick_locked("gin").rank == 1
        router._health.bump(1)
        assert router._pick_locked("gin").rank in (0, 1)  # last resort


def test_undecodable_replica_reply_fails_fast_not_hang(warm_server):
    server, samples = warm_server["server"], warm_server["samples"]
    host = ReplicaHost(server)
    router = _router(host, cache_bytes=0)
    real = router._rt.round_trip
    try:
        def garbled(*args, **kwargs):
            if "predict" in kwargs:
                return {"garbage": np.asarray(1, np.int64)}
            return real(*args, **kwargs)

        router._rt.round_trip = garbled
        with pytest.raises(RuntimeError, match="undecodable"):
            router.submit("gin", samples[0]).result(timeout=10)
        assert router.stats()["failed"] == 1
    finally:
        router._rt.round_trip = real
        router.stop()
        host.close()


def test_auth_token_rejection_stays_loud(warm_server):
    server, samples = warm_server["server"], warm_server["samples"]
    host = ReplicaHost(server, auth_token="s3cret")
    try:
        for cfg in ({"peer_timeout": 5.0}, {"peer_timeout": 5.0, "auth": "nope"}):
            with pytest.raises(RuntimeError, match="auth token mismatch"):
                FleetRouter(cfg).attach("127.0.0.1", host.port)
        good = FleetRouter({"peer_timeout": 5.0, "auth": "s3cret"})
        good.attach("127.0.0.1", host.port)
        good.start()
        try:
            assert good.predict("gin", samples[:2])
        finally:
            good.stop()
    finally:
        host.close()


def test_failover_requeues_in_flight_requests_zero_lost(warm_server):
    """Two replicas; one dies mid-stream (its host severed like a host
    loss): every in-flight and queued request is answered by the survivor,
    bit-identically to the direct server, and the dead replica is
    quarantined."""
    server, samples = warm_server["server"], warm_server["samples"]
    direct = [_heads(server.submit("gin", samples[i]).result(timeout=30)) for i in range(24)]
    h1, h2 = ReplicaHost(server), ReplicaHost(server)
    router = _router(h1, h2, cache_bytes=0)
    try:
        h1.set_delay(0.05)  # requests are in flight on h1 when it dies
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            futs = [router.submit("gin", samples[i], priority="batch") for i in range(24)]
            time.sleep(0.08)
            h1.close()
            got = [_heads(f.result(timeout=60)) for f in futs]
        for d, g in zip(direct, got):
            for a, b in zip(d, g):
                assert np.array_equal(a, b)
        st = router.stats()
        assert st["served"] == 24 and st["failed"] == 0
        assert st["failovers"] >= 1 and st["requeues"] >= 1
        assert st["replicas"][0]["quarantined"] and st["replicas"][1]["served"] >= 12
    finally:
        router.stop()
        h2.close()
        h1.close()


class _Dribbler:
    """A fake replica that answers pings like a ready twin but dribbles its
    predict answers one byte per tick: only the watchdog's round-trip
    deadline catches it."""

    def __init__(self, models=("gin",)):
        self._models = ",".join(models)
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                z = wire.unpack_arrays(wire.recv_msg(conn))
                if "ping" in z:
                    wire.send_msg(conn, wire.pong_frame(
                        ready=np.asarray(1, np.int64), models=wire.text_field(self._models),
                        quantized=np.zeros(1, np.int64)))
                    continue
                for b in wire.HDR.pack(1 << 20):
                    time.sleep(0.1)
                    conn.sendall(bytes([b]))
        except (OSError, ValueError, ConnectionError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        _close_listener(self._srv, self._thread)


def test_dribbling_replica_severed_and_failed_over(warm_server):
    server, samples = warm_server["server"], warm_server["samples"]
    real = ReplicaHost(server)
    drib = _Dribbler()
    router = FleetRouter({"peer_timeout": 0.4, "cache_bytes": 0, "quarantine_base_s": 30.0})
    try:
        router.attach("127.0.0.1", drib.port)
        router.attach("127.0.0.1", real.port)
        router.start()
        t0 = time.monotonic()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            futs = [router.submit("gin", samples[i], priority="batch") for i in range(6)]
            got = [f.result(timeout=30)["heads"] for f in futs]
        assert len(got) == 6 and time.monotonic() - t0 < 15.0
        st = router.stats()
        assert st["failovers"] >= 1 and st["requeues"] >= 1
        assert st["replicas"][0]["quarantined"] and not st["replicas"][1]["quarantined"]
        assert any("watchdog" in str(w.message) for w in rec)
    finally:
        router.stop()
        drib.close()
        real.close()


# -- traffic and config ---------------------------------------------------------


def test_traffic_generators_equal_jax():
    """The seeded request orders and priority plans: the JAX package's."""
    z1 = zipf_duplicate_order(400, 32, alpha=1.2, seed=9)
    np.testing.assert_array_equal(z1, jax_traffic.zipf_duplicate_order(400, 32, alpha=1.2,
                                                                       seed=9))
    assert z1.min() >= 0 and z1.max() < 32
    assert (z1 != zipf_duplicate_order(400, 32, alpha=1.2, seed=10)).any()
    p1 = mixed_priority_plan(200, seed=4)
    assert p1 == jax_traffic.mixed_priority_plan(200, seed=4)
    assert set(p1) <= {"interactive", "batch", "best_effort"}
    with pytest.raises(ValueError):
        mixed_priority_plan(10, mix={"interactive": -1.0})
    with pytest.raises(ValueError):
        zipf_duplicate_order(10, 0)


def test_run_traffic_priorities_reach_router_and_tag_report(warm_server):
    server, samples = warm_server["server"], warm_server["samples"]
    host = ReplicaHost(server)
    router = _router(host, cache_bytes=0)
    try:
        pri = mixed_priority_plan(12, seed=0)
        rep = run_traffic(router, "gin", samples[:8], 12, priorities=pri, seed=1)
        assert rep.n_served == 12 and set(rep.latencies_by_tag) == set(pri)
        assert sum(len(v) for v in rep.latencies_by_tag.values()) == 12
        assert rep.summary()[f"p99_ms_{pri[0]}"] is not None
        direct = run_traffic(server, "gin", samples[:8], 12, seed=1)
        assert direct.n_served == 12 and direct.summary()["p50_ms"] is not None
    finally:
        router.stop()
        host.close()


def test_fleet_config_block_schema_equals_jax(warm_server):
    """``update_config`` fills ``Serving.fleet`` as the JAX package fills it
    (a partial block keeps the caller's keys); typos and bad values raise at
    config load; a config the JAX package augmented is accepted whole."""
    from hydragnn_tpu.config import update_config as jax_update_config

    samples = warm_server["samples"][:6]
    assert fleet_config_defaults() == jax_fleet_config.fleet_config_defaults()
    aug = update_config(copy.deepcopy(CI_CONFIG), samples)
    assert aug["Serving"]["fleet"] == fleet_config_defaults()
    part = copy.deepcopy(CI_CONFIG)
    part["Serving"] = {"fleet": {"replicas": 4, "cache_bytes": 123,
                                 "autoscale": {"target_p99_ms": 42.0}}}
    aug2 = update_config(copy.deepcopy(part), samples)
    jaug2 = jax_update_config(copy.deepcopy(part), warm_server["jsamples"][:6])
    assert aug2["Serving"] == jaug2["Serving"]
    cfg = FleetConfig.from_config(aug2)
    assert cfg.replicas == 4 and cfg.cache_bytes == 123
    assert cfg.autoscaler_config().target_p99_ms == 42.0
    ServingConfig.from_config(jaug2).validate()
    for bad, match in (({"replicaz": 2}, "replicaz"), ({"replicas": 0}, "replicas"),
                       ([], "fleet"), ({"autoscale": {"bogus": 1}}, "bogus")):
        cfg = copy.deepcopy(CI_CONFIG)
        cfg["Serving"] = {"fleet": bad}
        with pytest.raises(ValueError, match=match):
            update_config(cfg, samples)


def test_autoscale_rollout_config_blocks():
    assert fleet_config_defaults()["autoscale"] == autoscaler_config_defaults()
    assert fleet_config_defaults()["rollout"] == rollout_config_defaults()
    with pytest.raises(ValueError, match="target_p99_mz"):
        AutoscalerConfig.from_config({"autoscale": {"target_p99_mz": 1}})
    with pytest.raises(ValueError, match="canary_probez"):
        RolloutConfig.from_config({"rollout": {"canary_probez": 1}})
    with pytest.raises(ValueError, match="bogus"):
        FleetConfig(rollout={"bogus": 1}).validate()
    with pytest.raises(ValueError, match="down_fraction"):
        AutoscalerConfig(down_fraction=1.5).validate()
    with pytest.raises(ValueError, match="max_replicas"):
        AutoscalerConfig(min_replicas=4, max_replicas=2).validate()
    with pytest.raises(ValueError, match="canary_probes"):
        RolloutConfig(canary_probes=0).validate()
    with pytest.raises(ValueError, match="boot_timeout_s"):
        FleetConfig(boot_timeout_s=0).validate()
    with pytest.raises(ValueError, match="quarantine_jitter"):
        FleetConfig(quarantine_jitter=-0.1).validate()
    cfg = AutoscalerConfig.from_config({"Serving": {"fleet": {"autoscale": {
        "target_p99_ms": 42.0}}}})
    assert cfg.target_p99_ms == 42.0 and cfg.enabled is False


# -- blue/green rollout ----------------------------------------------------------


def test_blue_green_cutover_atomicity_and_zero_drop(warm_server):
    """Requests admitted during the swap are served once each, bit-identical
    to the direct server; blue drains clean and retires; green serves."""
    server, samples = warm_server["server"], warm_server["samples"]
    blue, green = ReplicaHost(server), ReplicaHost(server)
    router = _router(blue, cache_bytes=0)
    try:
        direct = [_heads(server.submit("gin", s).result(timeout=30)) for s in samples[:6]]
        blue.set_delay(0.15)
        futs = [router.submit("gin", samples[i]) for i in range(3)]
        box = {}

        def _roll():
            box["report"] = blue_green_rollout(router, [green], probes=[("gin", samples[0])],
                                               config={"rollout": {"canary_probes": 1}})

        th = threading.Thread(target=_roll)
        th.start()
        mid = [router.submit("gin", samples[3 + i]) for i in range(3)]
        th.join(timeout=60)
        assert not th.is_alive(), "rollout wedged"
        blue.set_delay(0.0)
        got = [_heads(f.result(timeout=30)) for f in futs + mid]
        for d, g in zip(direct, got):
            for a, b in zip(d, g):
                assert np.array_equal(a, b)
        st = router.stats()
        assert st["served"] == 6 and st["failed"] == 0
        report = box["report"]
        assert report["blue_ranks"] == [0] and report["green_ranks"] == [1]
        assert all(report["drained"].values()) and report["canary"] == {0: "ok"}
        assert router.active_ranks() == [1]
        assert router.submit("gin", samples[6]).result(timeout=30)["heads"]
    finally:
        blue.set_delay(0.0)
        router.stop()
        green.close()
        blue.close()


class _WrongAnswerHost(wire.WireServer):
    """A green replica whose answers are the wrong bits."""

    def pong_fields(self):
        return {"ready": np.asarray(1, np.int64), "models": wire.text_field("gin"),
                "quantized": np.zeros(1, np.int64)}

    def handle_frame(self, z):
        if "predict" in z:
            return {"n": np.asarray(1, np.int64), "nheads": np.asarray(1, np.int64),
                    "latency_s": np.asarray(0.0, np.float64),
                    "h0": np.zeros((3, 1), np.float32)}
        raise ValueError(f"unexpected fleet op in frame keys {sorted(z)}")


def test_canary_refuses_a_mismatched_model_live_set_untouched(warm_server):
    """A green generation whose answers differ is refused with
    CanaryMismatchError, never attached, and the live set keeps serving
    its own answers; an empty probe list with the canary armed refuses
    too; an identical twin passes ``run_canary``."""
    from hydragnn_tpu_torch.serve.fleet.rollout import run_canary

    server, samples = warm_server["server"], warm_server["samples"]
    blue, twin = ReplicaHost(server), ReplicaHost(server)
    router = _router(blue, cache_bytes=0)
    impostor = _WrongAnswerHost(host="127.0.0.1", port=0, name="WrongAnswerHost")
    try:
        before = [_heads(router.submit("gin", s).result(timeout=30)) for s in samples[:2]]
        assert run_canary(router, [("127.0.0.1", twin.port)],
                          [("gin", samples[0]), ("gin", samples[1])],
                          RolloutConfig()) == {0: "ok"}
        with pytest.raises(CanaryMismatchError):
            blue_green_rollout(router, [("127.0.0.1", impostor.port)],
                               probes=[("gin", samples[0])])
        st = router.stats()
        assert len(st["replicas"]) == 1 and router.active_ranks() == [0]
        after = [_heads(router.submit("gin", s).result(timeout=30)) for s in samples[:2]]
        for d, g in zip(before, after):
            for a, b in zip(d, g):
                assert np.array_equal(a, b)
        with pytest.raises(ValueError, match="probe"):
            blue_green_rollout(router, [("127.0.0.1", impostor.port)], probes=[])
    finally:
        router.stop()
        impostor.close()
        twin.close()
        blue.close()


# -- the autoscaler's decisions under pinned clocks ---------------------------


class _FakeHandle:
    _next_port = 9700

    def __init__(self):
        _FakeHandle._next_port += 1
        self.host = "127.0.0.1"
        self.port = _FakeHandle._next_port
        self.terminated = False

    def terminate(self):
        self.terminated = True


class _FakeRouter:
    """Scripted stats and attach/retire bookkeeping."""

    def __init__(self, replicas=1):
        self.ranks = list(range(replicas))
        self._next = replicas
        self.p99, self.queue, self.shed = 10.0, 0, 0
        self.retired = []

    def stats(self):
        return {"queue_depths": {"interactive": self.queue},
                "latency_p99_ms": {"interactive": self.p99}, "shed": self.shed,
                "active_replicas": len(self.ranks)}

    def attach(self, host, port):
        rank = self._next
        self._next += 1
        self.ranks.append(rank)
        return rank

    def retire(self, rank, timeout_s=30.0):
        self.ranks.remove(rank)
        self.retired.append(rank)
        return True

    def active_ranks(self):
        return list(self.ranks)


def _cfg(**kw):
    for k, v in dict(enabled=True, target_p99_ms=100.0, up_consecutive=2, down_consecutive=3,
                     cooldown_s=5.0, min_replicas=1, max_replicas=3).items():
        kw.setdefault(k, v)
    return AutoscalerConfig(**kw)


def test_autoscaler_decision_loop_scales_up_and_down():
    router = _FakeRouter(replicas=1)
    spawned = []

    def spawn():
        h = _FakeHandle()
        spawned.append(h)
        return h

    a = Autoscaler(router, _cfg(), spawn_fn=spawn)
    router.p99 = 250.0
    assert a.step(now=0.0)[0] == HOLD
    act, reason = a.step(now=1.0)
    assert act == SCALE_UP and "p99" in reason
    assert len(router.ranks) == 2 and len(spawned) == 1
    assert a.step(now=2.0) == (HOLD, "cooldown")
    a.step(now=3.0)
    assert a.step(now=7.0)[0] == SCALE_UP and len(router.ranks) == 3
    a.step(now=13.0)
    act, reason = a.step(now=14.0)
    assert act == HOLD and "max_replicas" in reason
    router.p99 = 10.0
    assert a.step(now=20.0)[0] == HOLD and a.step(now=21.0)[0] == HOLD
    act, reason = a.step(now=22.0)
    assert act == SCALE_DOWN and "calm" in reason
    assert router.retired == [2] and spawned[1].terminated and not spawned[0].terminated
    for t in (28.0, 29.0, 30.0):
        act, _ = a.step(now=t)
    assert act == SCALE_DOWN and router.retired == [2, 1] and spawned[0].terminated
    for t in (36.0, 37.0, 38.0, 39.0):
        act, _ = a.step(now=t)
    assert act == HOLD and router.ranks == [0]
    assert len(a.actions) == 17
    assert sum(r["action"] == SCALE_UP for r in a.actions) == 2
    assert sum(r["action"] == SCALE_DOWN for r in a.actions) == 2


def test_autoscaler_breach_kinds_and_streak_resets():
    cfg = _cfg()
    router = _FakeRouter(replicas=2)
    a = Autoscaler(router, cfg, spawn_fn=_FakeHandle)
    router.queue = cfg.max_queue_per_replica * 2 + 1
    a.step(now=0.0)
    act, reason = a.step(now=1.0)
    assert act == SCALE_UP and "backlog" in reason
    router2 = _FakeRouter(replicas=2)
    b = Autoscaler(router2, cfg, spawn_fn=_FakeHandle)
    router2.shed = 50
    b.step(now=0.0)
    assert b.state.breach_streak <= 1
    b.step(now=1.0)
    assert b.state.breach_streak == 0
    st = AutoscalerState(breach_streak=1, calm_streak=2)
    act, _ = decide(cfg, st, Signals(p99_ms=50.0, queue_depth=0, shed_total=0,
                                     active_replicas=2), now=100.0)
    assert act == HOLD and st.breach_streak == 0 and st.calm_streak == 0


def test_autoscaler_lifecycle_and_signal_extraction():
    with pytest.raises(ValueError, match="spawn_fn"):
        Autoscaler(_FakeRouter(), _cfg()).start()
    a = Autoscaler(_FakeRouter(), _cfg(interval_s=30.0), spawn_fn=_FakeHandle)
    with a:
        assert a._thread.is_alive()
    assert a._thread is None
    sig = Signals.from_stats({"queue_depths": {"interactive": 3, "batch": 4},
                              "latency_p99_ms": {"interactive": 120.5}, "shed": 7,
                              "active_replicas": 2})
    assert sig == Signals(p99_ms=120.5, queue_depth=7, shed_total=7, active_replicas=2)
    assert Signals.from_stats({}) == Signals(p99_ms=None, queue_depth=0, shed_total=0,
                                             active_replicas=0)


# -- the replica worker: ready files, boot timeout, boot from checkpoints ---------


def test_ready_file_hardening_typed_errors(tmp_path):
    torn = tmp_path / "ready.json"
    torn.write_text('{"port": 51')
    with pytest.raises(ReplicaBootError, match="partial contents") as e:
        _read_ready_file(str(torn))
    assert '{"port": 51' in str(e.value) and "ready.json" in str(e.value)
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    with pytest.raises(ReplicaBootError, match="boot contract"):
        _read_ready_file(str(bad))
    with pytest.raises(ReplicaBootError, match="unreadable"):
        _read_ready_file(str(tmp_path / "missing.json"))
    ok = tmp_path / "ok.json"
    ok.write_text('{"port": 1234, "pid": 7}')
    assert _read_ready_file(str(ok))["port"] == 1234


def test_spawn_replica_boot_timeout_from_config():
    spec = {"models": [], "serving": {"fleet": {"boot_timeout_s": 0.3}}}
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="0.3"):
        spawn_replica(spec)  # the worker cannot import torch in 0.3 s
    assert time.monotonic() - t0 < 60.0


def test_health_table_quarantine_backoff_jitter():
    ht = wire.HealthTable(base_s=1.0, cap_s=8.0, jitter=0.5)
    spans = []
    for k in range(40):
        now = time.monotonic()
        ht.bump(k)
        spans.append(ht.entries[k]["until"] - now)
    assert all(0.99 <= s <= 1.51 for s in spans) and max(spans) - min(spans) > 0.02
    ht0 = wire.HealthTable(base_s=1.0, cap_s=8.0, jitter=0.0)
    now = time.monotonic()
    ht0.bump("a")
    assert abs((ht0.entries["a"]["until"] - now) - 1.0) < 0.05
    now = time.monotonic()
    ht0.bump("a")
    assert abs((ht0.entries["a"]["until"] - now) - 2.0) < 0.05
    assert ht0.entries["a"]["backoff"] == 4.0


def _checkpointed_spec(warm_server, tmp_path, **serving):
    """The warm server's model as a training run leaves it (``config.json``
    and a checkpoint), a samples file, and a worker spec on the CPU."""
    from hydragnn_tpu_torch.config.schema import save_config
    from hydragnn_tpu_torch.train import create_train_state
    from hydragnn_tpu_torch.train.checkpoint import save_checkpoint

    logs = str(tmp_path / "logs")
    aug, model = warm_server["aug"], warm_server["model"]
    save_config(aug, "fleet_ckpt", path=logs)
    state = create_train_state(copy.deepcopy(model), aug["NeuralNetwork"]["Training"]["Optimizer"])
    save_checkpoint(state, "fleet_ckpt", epoch=0, path=logs)
    samples_file = write_samples_file(warm_server["samples"], str(tmp_path / "samples.wire"))
    return {"models": [{"name": "gin", "log_name": "fleet_ckpt", "path": logs,
                        "samples_file": samples_file, "batch_size": 8}],
            "serving": {"flush_ms": 2.0, **serving}, "device": "cpu"}


def test_replica_server_boots_from_checkpoint_paths(warm_server, tmp_path):
    """The worker's boot, in process (the subprocess test's stand-in): a
    server built from the spec's checkpoint paths alone answers through a
    router bit-identically to the live server, with no capture after
    ready."""
    spec = _checkpointed_spec(warm_server, tmp_path)
    booted = _build_server(spec)
    booted.warmup()
    booted.start()
    host = ReplicaHost(booted)
    router = _router(host, cache_bytes=0)
    try:
        samples = warm_server["samples"][:4]
        direct = [_heads(warm_server["server"].submit("gin", s).result(timeout=30))
                  for s in samples]
        routed = [_heads(router.submit("gin", s).result(timeout=30)) for s in samples]
        for d, r in zip(direct, routed):
            for a, b in zip(d, r):
                assert np.array_equal(a, b)
        assert router.replica_stats(0)["steady_captures"] == 0
    finally:
        router.stop()
        host.close()
        booted.stop()


def test_subprocess_replica_boots_from_checkpoint_and_serves(warm_server, tmp_path):
    """``python -m hydragnn_tpu_torch.serve.fleet.replica``: a worker process
    boots from checkpoint paths alone on the CPU (the spec's ``device``),
    warms before it advertises ready, and serves through the router
    bit-identically to the in-process server; killed, its requests fail
    over to a sibling."""
    worker = spawn_replica(_checkpointed_spec(warm_server, tmp_path), timeout_s=300.0)
    sibling = ReplicaHost(warm_server["server"])
    router = FleetRouter({"peer_timeout": 30.0, "cache_bytes": 0})
    try:
        router.attach("127.0.0.1", worker.port)
        router.start()
        samples = warm_server["samples"][:6]
        direct = [_heads(warm_server["server"].submit("gin", s).result(timeout=30))
                  for s in samples]
        routed = [_heads(router.submit("gin", s).result(timeout=60)) for s in samples]
        for d, r in zip(direct, routed):
            for a, b in zip(d, r):
                assert np.array_equal(a, b)
        assert router.replica_stats(0)["steady_captures"] == 0
        router.attach("127.0.0.1", sibling.port)
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            futs = [router.submit("gin", s, priority="batch") for s in samples * 4]
            worker.kill()
            assert len([f.result(timeout=60) for f in futs]) == 24
        assert router.stats()["failed"] == 0
    finally:
        router.stop()
        sibling.close()
        worker.terminate()
