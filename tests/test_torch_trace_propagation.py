"""The port's trace-context propagation over the wire, held against the JAX
package's (``hydragnn_tpu/telemetry/propagation.py``, ``utils/wire.py``).

* the blob and the frame: a traced frame of the port and of the JAX package
  are the same bytes; with propagation off, or no ``request_id`` in scope,
  a frame is byte for byte the frame of a plain ``pack_arrays`` of its
  fields (no field added);
* interoperation both ways: a port ``RoundTripper`` to a JAX
  ``WireServer`` and a JAX ``RoundTripper`` to a port ``WireServer`` carry
  one ``request_id`` into the server's ``wire_serve`` record;
* one routed predict through the port's router and a replica with a fake
  endpoint (real sockets, no warm-up) journals under one ``request_id`` in
  the router's and the replica's directories, and the port's ``fleet``
  CLI merges them; with propagation off neither journal gains a record;
* a forced failover of the port's ``ShardedStore`` journals one
  ``store_hop`` per peer tried under one ``request_id``; untraced, none.

The counterparts of ``tests/test_trace_propagation.py:82-320``. Every
test runs in an isolated telemetry plane of each package; every server,
client and router is closed.
"""

import json
import types
import warnings
from concurrent.futures import Future

import numpy as np
import pytest

import hydragnn_tpu.telemetry as jtel
import hydragnn_tpu_torch.telemetry as tel
from hydragnn_tpu.utils import wire as jwire
from hydragnn_tpu.utils.retry import RetryPolicy as JaxRetryPolicy
from hydragnn_tpu_torch.telemetry import propagation
from hydragnn_tpu_torch.telemetry.cli import fleet_main
from hydragnn_tpu_torch.telemetry.journal import EventJournal, read_journal
from hydragnn_tpu_torch.utils import wire
from hydragnn_tpu_torch.utils.retry import RetryPolicy

from torch_port_util import joined_threads, port_telemetry  # noqa: F401  (fixtures)

_ONE = RetryPolicy(attempts=1)


@pytest.fixture(autouse=True)
def _fresh(joined_threads, port_telemetry):
    """Both packages' planes isolated, their overrides following the env."""
    with jtel.isolate():
        jtel.configure(None)
        tel.configure(None)
        yield


class _EchoServer(wire.WireServer):
    """A handler that reads only the keys it knows (the shape of a peer
    that predates the trace field)."""

    def handle_frame(self, z):
        return {"n": np.asarray(1, np.int64), "y": np.asarray(z["x"]) * 2}


class _JaxEchoServer(jwire.WireServer):
    def handle_frame(self, z):
        return {"n": np.asarray(1, np.int64), "y": np.asarray(z["x"]) * 2}


def test_traced_frames_equal_jax_and_off_adds_no_bytes():
    """The same fields under the same ambient ids: the port's frame is the
    JAX package's, byte for byte; off (or no request_id) nothing is
    added."""
    from hydragnn_tpu.telemetry import propagation as jprop

    def fields():
        return {"x": np.arange(4, dtype=np.float64), "token": wire.token_field("tok")}

    plain = wire.pack_arrays(fields())
    assert wire.pack_arrays(propagation.inject(fields())) == plain  # no request_id
    with tel.scoped_context(request_id="rid0123", run_id="runA", epoch=3), \
            jtel.scoped_context(request_id="rid0123", run_id="runA", epoch=3):
        ours = wire.pack_arrays(propagation.inject(fields()))
        theirs = jwire.pack_arrays(jprop.inject(fields()))
        assert ours == theirs != plain
        ctx = propagation.extract(wire.unpack_arrays(ours))
        assert ctx == {"request_id": "rid0123", "run_id": "runA", "epoch": 3}
        assert jprop.extract(jwire.unpack_arrays(ours)) == ctx
        tel.set_propagate_enabled(False)
        assert wire.pack_arrays(propagation.inject(fields())) == plain
    # legacy frames and garbage blobs degrade to untraced, never raise
    assert propagation.extract({"x": np.zeros(1)}) == {}
    assert propagation.extract(
        {propagation.TRACE_FIELD: np.frombuffer(b"not json", dtype=np.uint8)}) == {}


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_request_id_crosses_between_the_packages(tmp_path, direction):
    """One ``request_id`` from a client of one package into the
    ``wire_serve`` record of a server of the other; an untraced frame
    journals nothing."""
    if direction == "port_client_jax_server":
        journal = jtel.EventJournal(str(tmp_path / "events.jsonl"), run_id="srv")
        server = _JaxEchoServer(name="echo", journal=journal)
        rt, policy, scope = wire.RoundTripper(5.0), _ONE, tel.scoped_context
    else:
        journal = EventJournal(str(tmp_path / "events.jsonl"), run_id="srv")
        server = _EchoServer(name="echo", journal=journal)
        rt, policy, scope = jwire.RoundTripper(5.0), JaxRetryPolicy(attempts=1), \
            jtel.scoped_context
    try:
        z = rt.round_trip(("e", server.port), "127.0.0.1", server.port, policy=policy,
                          x=np.arange(3, dtype=np.float64))
        np.testing.assert_array_equal(z["y"], np.arange(3) * 2.0)
        with scope(request_id="ridAB"):
            z = rt.round_trip(("e", server.port), "127.0.0.1", server.port, policy=policy,
                              x=np.arange(3, dtype=np.float64))
        np.testing.assert_array_equal(z["y"], np.arange(3) * 2.0)
    finally:
        rt.close()
        server.close()
        server._thread.join(5.0)
        journal.close()
    recs = read_journal(str(tmp_path / "events.jsonl"))
    assert [r["kind"] for r in recs] == ["wire_serve"]
    assert recs[0]["request_id"] == "ridAB" and recs[0]["ok"] == 1 and recs[0]["op"] == "frame"


# -- the fleet: one request_id across the router's and a replica's journal ----


class _FakeEndpoint:
    def __init__(self):
        self.cfg = types.SimpleNamespace(quantize=False)
        self.quant_steps = {}


class _FakePredictServer:
    """Enough of ``PredictionServer`` for a routed predict: ``submit``
    answers at once with one head."""

    def __init__(self, served: int = 1):
        self._models = {"gin": _FakeEndpoint()}
        self._served = served

    def submit(self, model, sample):
        fut = Future()
        fut.set_result({"heads": [np.asarray(sample.x, np.float64).sum(axis=0)],
                        "latency_s": 0.001})
        return fut

    def stats(self):
        return {"gin": {"queue_depth": 0, "shed": 1, "served": self._served,
                        "submitted": self._served + 1, "captures": 0}}


def _sample(seed: int):
    from hydragnn_tpu_torch.datasets import deterministic_graph_data

    return deterministic_graph_data(number_configurations=1, seed=seed)[0]


def test_fleet_predict_shares_one_request_id_across_dirs(tmp_path, capsys):
    """Admission, dispatch, the replica's execution, the reply and the
    cache fill of one routed predict journal under one ``request_id`` in
    the router's and the replica's directories; a duplicate is a cache hit
    of its own request; the ``fleet`` CLI merges both into one ordered
    timeline and one trace."""
    from hydragnn_tpu_torch.serve.fleet import FleetRouter, ReplicaHost

    router_dir, replica_dir = tmp_path / "router", tmp_path / "replica0"
    tel.open_journal(file=str(router_dir / "events.jsonl"), run_id="router")
    rep_journal = EventJournal(str(replica_dir / "events.jsonl"), run_id="replica0")
    sample = _sample(11)
    host = ReplicaHost(_FakePredictServer(), journal=rep_journal)
    router = FleetRouter({"peer_timeout": 5.0, "cache_bytes": 1 << 16})
    try:
        router.attach("127.0.0.1", host.port)
        router.start()
        assert len(router.submit("gin", sample).result(timeout=30)["heads"]) == 1
        assert router.submit("gin", sample).result(timeout=30).get("cached") is True
    finally:
        router.stop()
        host.close()
        host._thread.join(5.0)
        rep_journal.close()
        tel.close_journal()
    router_recs = read_journal(str(router_dir / "events.jsonl"))
    rep_recs = read_journal(str(replica_dir / "events.jsonl"))
    assert {"fleet_admit", "fleet_dispatch", "fleet_reply", "fleet_cache_fill",
            "fleet_cache_hit"} <= {r["kind"] for r in router_recs}
    rid = next(r["request_id"] for r in router_recs if r["kind"] == "fleet_admit")
    first = [r for r in router_recs if r.get("request_id") == rid]
    assert {"fleet_admit", "fleet_dispatch", "fleet_reply", "fleet_cache_fill"} <= {
        r["kind"] for r in first}
    assert {"replica_execute", "wire_serve"} <= {
        r["kind"] for r in rep_recs if r.get("request_id") == rid}

    merged = str(tmp_path / "fleet_trace.json")
    assert fleet_main([str(router_dir), str(replica_dir), "--trace-out", merged]) == 0
    out = capsys.readouterr().out
    assert rid in out and "2 process(es)" in out
    section = out.split("fleet timeline")[0]
    assert section.index("fleet_admit") < section.index("replica_execute") \
        < section.index("fleet_reply")


def test_fleet_predict_propagation_disabled_emits_nothing(tmp_path):
    """Propagation off: no request id is minted, neither journal gains a
    per-request record, and the predict answers."""
    from hydragnn_tpu_torch.serve.fleet import FleetRouter, ReplicaHost

    tel.set_propagate_enabled(False)
    tel.open_journal(file=str(tmp_path / "router" / "events.jsonl"), run_id="router")
    rep_journal = EventJournal(str(tmp_path / "replica0" / "events.jsonl"), run_id="replica0")
    host = ReplicaHost(_FakePredictServer(), journal=rep_journal)
    router = FleetRouter({"peer_timeout": 5.0, "cache_bytes": 0})
    try:
        router.attach("127.0.0.1", host.port)
        router.start()
        assert len(router.submit("gin", _sample(12)).result(timeout=30)["heads"]) == 1
    finally:
        router.stop()
        host.close()
        host._thread.join(5.0)
        rep_journal.close()
        tel.close_journal()
    assert read_journal(str(tmp_path / "router" / "events.jsonl")) == []
    assert read_journal(str(tmp_path / "replica0" / "events.jsonl")) == []


def test_fleet_metrics_op_aggregates_two_fake_replicas():
    """The ``metrics`` op and ``FleetRouter.metrics()`` over two replicas
    (real sockets and codec, fake endpoints): each answers its stats and
    registry, the aggregate sums them, ``steady_captures`` 0."""
    from hydragnn_tpu_torch.serve.fleet import FleetRouter, ReplicaHost

    host_a = ReplicaHost(_FakePredictServer(served=3))
    host_b = ReplicaHost(_FakePredictServer(served=5))
    router = FleetRouter({"peer_timeout": 5.0, "cache_bytes": 1 << 16})
    try:
        router.attach("127.0.0.1", host_a.port)
        router.attach("127.0.0.1", host_b.port)
        m = router.metrics()
    finally:
        router._rt.close()
        for h in (host_a, host_b):
            h.close()
            h._thread.join(5.0)
    assert sorted(m["replicas"]) == ["0", "1"]
    for rank in ("0", "1"):
        rep = m["replicas"][rank]
        assert set(rep["registry"]) == {"counters", "gauges", "histograms"}
        assert rep["stats"]["steady_captures"] == 0
    agg = m["aggregate"]
    assert (agg["replicas_total"], agg["replicas_reporting"]) == (2, 2)
    assert (agg["served"], agg["shed"], agg["steady_captures"], agg["queue_depth"]) == (8, 2, 0, 0)
    assert "fleet_cache_hits" in m["registry"]["gauges"]
    assert json.loads(json.dumps(m)) == m


# -- the sharded store: failover hops under one id ----------------------------


def _store_pair(tmp_path, n_local=4, n_remote=4):
    from hydragnn_tpu_torch.datasets import deterministic_graph_data
    from hydragnn_tpu_torch.datasets.packed import PackedWriter
    from hydragnn_tpu_torch.datasets.sharded import ShardedStore

    samples = deterministic_graph_data(number_configurations=n_local + n_remote, seed=5)
    n = n_local + n_remote
    p_local, p_remote = str(tmp_path / "l.gpk"), str(tmp_path / "r.gpk")
    PackedWriter(samples[:n_local], p_local)
    PackedWriter(samples[n_local:], p_remote)
    replicas = [ShardedStore(p_remote, n_local, n, bind_host="127.0.0.1",
                             peers=[("127.0.0.1", 0, 0, n_local), ("127.0.0.1", 0, n_local, n)])
                for _ in range(2)]
    peers = [("127.0.0.1", 0, 0, n_local)] + [
        ("127.0.0.1", r.server.port, n_local, n) for r in replicas]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        client = ShardedStore(p_local, 0, n_local, peers=peers, bind_host="127.0.0.1",
                              replication_factor=2, peer_timeout=5.0)
    return samples, client, replicas


def test_store_forced_failover_hops_share_request_id(tmp_path):
    """One of two owners dead and tried first: hop 0 ``quarantined`` names
    it, hop 1 ``served`` names the winner, both under one request id; the
    store's counters land in the registry."""
    samples, client, replicas = _store_pair(tmp_path)
    tel.open_journal(file=str(tmp_path / "logs" / "events.jsonl"), run_id="store")
    try:
        dead = replicas[0]
        dead_rank = next(r for r, p in enumerate(client.peers) if p[1] == dead.server.port)
        dead.close()
        order = client._health_table.order
        client._health_table.order = lambda ranks, rot=0: sorted(
            order(ranks, rot=rot), key=lambda r: r != dead_rank)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = client.fetch([6])
        np.testing.assert_array_equal(np.asarray(got[0].x), np.asarray(samples[6].x))
        stats = client.stats()
    finally:
        client.close()
        for r in replicas:
            r.close()
        tel.close_journal()
    hops = [r for r in read_journal(str(tmp_path / "logs" / "events.jsonl"))
            if r["kind"] == "store_hop"]
    assert len(hops) == 2 and len({r.get("request_id") for r in hops} - {None}) == 1
    assert [(h["hop"], h["peer"], h["outcome"]) for h in hops] == [
        (0, dead_rank, "quarantined"), (1, hops[1]["peer"], "served")]
    assert hops[1]["peer"] != dead_rank and hops[1]["failed_over"] is True
    counters = tel.snapshot()["counters"]
    assert counters["store_remote_fetches_total"][""] == 1
    assert counters["store_failover_fetches_total"][""] == 1
    assert counters["store_quarantine_events_total"][""] == 1
    assert tel.snapshot()["gauges"]["sharded_store_failover_fetches"][""] == \
        stats["failover_fetches"] == 1


def test_store_untraced_fetch_emits_no_hops(tmp_path):
    """Propagation off: a fetch journals no hop."""
    samples, client, replicas = _store_pair(tmp_path)
    tel.set_propagate_enabled(False)
    tel.open_journal(file=str(tmp_path / "logs" / "events.jsonl"), run_id="store")
    try:
        got = client.fetch([5, 7])
        np.testing.assert_array_equal(np.asarray(got[1].x), np.asarray(samples[7].x))
    finally:
        client.close()
        for r in replicas:
            r.close()
        tel.close_journal()
    assert [r for r in read_journal(str(tmp_path / "logs" / "events.jsonl"))
            if r["kind"] == "store_hop"] == []
