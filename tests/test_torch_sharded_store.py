"""The port's sharded sample exchange (``hydragnn_tpu_torch.datasets.sharded``)
on the CPU: several "hosts" in one process, each owning a range of the
corpus as a local packed shard, mirroring the JAX package's store tests
(``tests/test_datasets.py``): remote fetches, the auth token, cache
isolation, a fetch across owners with a stale pooled socket, the size table
and the misroute guard, ``fetch_many``, failover at ``replication_factor``
2 with one server stopped, and the prober's quarantine lift; and the wire
across packages: a port store reading from a JAX ``ShardServer`` and a JAX
store reading from a port one, the samples bit-equal.

Every socket binds 127.0.0.1 on an ephemeral port and every store here
has a peer timeout of a few seconds, so no test can wait on a socket for
long.
"""

import threading
import time

import numpy as np
import pytest

import torch_port_util as tpu
from hydragnn_tpu.datasets.packed import PackedDataset as JaxPacked
from hydragnn_tpu.datasets.packed import PackedWriter as JaxWriter
from hydragnn_tpu.datasets.sharded import ShardedStore as JaxStore
from hydragnn_tpu.datasets.sharded import ShardServer as JaxServer
from hydragnn_tpu_torch.datasets import deterministic_graph_data
from hydragnn_tpu_torch.datasets.packed import PackedDataset, PackedWriter
from hydragnn_tpu_torch.datasets.sharded import ShardedStore, ShardServer, store_config_defaults

HOST = "127.0.0.1"
TIMEOUT = 5.0


def _store(path, start, stop, peers, **kw):
    kw.setdefault("peer_timeout", TIMEOUT)
    return ShardedStore(path, start, stop, peers=peers, bind_host=HOST, **kw)


def _shards(tmp_path, n, cuts, seed=4):
    samples = deterministic_graph_data(number_configurations=n, seed=seed)
    bounds = [0, *cuts, n]
    paths = []
    for k, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        paths.append(str(tmp_path / f"shard{k}.gpk"))
        PackedWriter(samples[lo:hi], paths[-1])
    return samples, paths, list(zip(bounds[:-1], bounds[1:]))


def _pair(tmp_path, n=20, cut=12, **kw):
    """Two stores, each owning one shard and knowing the other."""
    samples, (p0, p1), _ = _shards(tmp_path, n, [cut])
    s0 = _store(p0, 0, cut, [(HOST, 0, 0, cut)], **kw)
    s1 = _store(p1, cut, n, [(HOST, s0.server.port, 0, cut), (HOST, 0, cut, n)], **kw)
    s0.peers = [(HOST, s0.server.port, 0, cut), (HOST, s1.server.port, cut, n)]
    s0.total = s1.total = n
    return samples, s0, s1


def test_remote_samples_equal_local_reads_and_the_loader_spans_the_corpus(tmp_path):
    samples, s0, s1 = _pair(tmp_path)
    try:
        assert len(s0) == len(s1) == 20
        for i in (0, 5, 11, 12, 19):
            tpu.assert_samples_equal([s0[i]], [s1[i]], f"index {i}")
            np.testing.assert_array_equal(s0[i].pos, samples[i].pos)
        before = s0.remote_fetches
        got = s0.fetch(list(range(8, 16)))
        assert s0.remote_fetches == before + 3  # 12 was cached above
        tpu.assert_samples_equal(got, [s0[i] for i in range(8, 16)], "fetch")
        s0.fetch(list(range(12, 16)))
        assert s0.remote_fetches == before + 3  # all cache hits
        batch = next(iter(s0.loader(4, rank=0, world=2, seed=1)))
        assert batch.graph_mask.sum() == 4
        assert s0.stats()["remote_fetches"] == s0.remote_fetches
    finally:
        s0.close()
        s1.close()


def test_auth_token_guards_the_shard(tmp_path):
    samples, (p0, p1), _ = _shards(tmp_path, 12, [6], seed=3)
    srv = _store(p1, 6, 12, [(HOST, 0, 0, 6), (HOST, 0, 6, 12)], auth_token="s3cret")
    peers = [(HOST, 0, 0, 6), (HOST, srv.server.port, 6, 12)]
    bad = _store(p0, 0, 6, peers, auth_token="wrong")
    good = _store(p0, 0, 6, peers, auth_token="s3cret")
    try:
        with pytest.raises(RuntimeError, match="auth token"):
            bad[8]
        np.testing.assert_array_equal(good[8].x, samples[8].x)
    finally:
        for s in (bad, good, srv):
            s.close()


def test_cache_hits_are_isolated_copies(tmp_path):
    samples, (p0, p1), _ = _shards(tmp_path, 12, [6], seed=5)
    srv = _store(p1, 6, 12, [(HOST, 0, 0, 6), (HOST, 0, 6, 12)])
    store = _store(p0, 0, 6, [(HOST, 0, 0, 6), (HOST, srv.server.port, 6, 12)])
    try:
        pristine = np.array(samples[8].x)
        first = store.fetch([8])[0]
        first.x[:] = -777.0
        first.extras["poison"] = True
        hit = store.fetch([8])[0]
        assert store.remote_fetches == 1
        np.testing.assert_array_equal(hit.x, pristine)
        assert "poison" not in hit.extras
        hit.x[:] = -888.0
        np.testing.assert_array_equal(store.fetch([8])[0].x, pristine)
        a, b = store.fetch([8, 8])
        a.x[:] = -999.0
        np.testing.assert_array_equal(b.x, pristine)
        local = store.fetch([2])[0]  # a local read: a read-only mmap view
        assert not local.x.flags.writeable
    finally:
        store.close()
        srv.close()


def test_fetch_across_owners_and_a_stale_pooled_socket(tmp_path):
    samples, paths, spans = _shards(tmp_path, 18, [6, 12], seed=6)
    stores = []
    for k, (lo, hi) in enumerate(spans):
        peers = [(HOST, s.server.port if s else 0, a, b)
                 for (a, b), s in zip(spans, stores + [None] * (3 - len(stores)))]
        stores.append(_store(paths[k], lo, hi, peers, cache_size=2))
    s0 = stores[0]
    s0.peers = [(HOST, st.server.port, a, b) for st, (a, b) in zip(stores, spans)]
    try:
        got = s0.fetch(list(range(2, 16)))
        for i, s in zip(range(2, 16), got):
            np.testing.assert_array_equal(s.x, samples[i].x)
        for stack in s0._pool._idle.values():
            for sock in stack:
                sock.close()
        got = s0.fetch([16, 17, 6])
        np.testing.assert_array_equal(got[0].x, samples[16].x)
        np.testing.assert_array_equal(got[2].x, samples[6].x)
        assert len(s0._cache) <= 2
    finally:
        for st in stores:
            st.close()


def test_size_table_and_misroute_guard(tmp_path):
    samples, s0, s1 = _pair(tmp_path, n=16, cut=10)
    try:
        sz = s0.sample_sizes(range(16))
        np.testing.assert_array_equal(sz, [(s.num_nodes, s.num_edges) for s in samples])
        assert s0.remote_fetches == 0
        plan = s0.loader(4, buckets=[s0.pad_spec(4)]).batch_plan()
        assert len(plan) == 4 and s0.remote_fetches == 0
        bad = _store(str(tmp_path / "shard0.gpk"), 0, 10, [(HOST, 0, 0, 10)])
        bad.peers = [(HOST, bad.server.port, 0, 10), (HOST, bad.server.port, 10, 16)]
        bad.total = 16
        with pytest.raises(RuntimeError, match="misrouted"):
            bad[12]
        bad.close()
    finally:
        s0.close()
        s1.close()


def test_fetch_many_bypasses_the_cache(tmp_path):
    samples, s0, s1 = _pair(tmp_path)
    try:
        got = s0.fetch_many(list(range(8, 16)))
        assert s0.remote_fetches == 4 and len(s0._cache) == 0
        for i, s in zip(range(8, 16), got):
            np.testing.assert_array_equal(s.x, samples[i].x)
        s0.fetch_many([12, 13])
        assert s0.remote_fetches == 6
        a, b = s0.fetch_many([15, 15])
        assert s0.remote_fetches == 7
        a.x[:] = -123.0
        np.testing.assert_array_equal(b.x, samples[15].x)
        s0.fetch([16])
        s0.fetch_many([16])
        s0.fetch([16])
        assert len(s0._cache) == 1 and s0.remote_fetches == 9
    finally:
        s0.close()
        s1.close()


def test_failover_to_a_replica_and_the_prober_lifts_the_quarantine(tmp_path):
    """Replication 2: the range [6, 12) on two servers; one stopped mid-way,
    fetches fail over to its mirror with no sample lost; restarted at its
    address, the prober lifts its quarantine; ``close()`` leaves no prober
    or server thread alive."""
    samples, (p0, p1), _ = _shards(tmp_path, 12, [6], seed=9)
    a = ShardServer(PackedDataset(p1), 6, 12, host=HOST)
    b = ShardServer(PackedDataset(p1), 6, 12, host=HOST)
    peers = [(HOST, 0, 0, 6), (HOST, a.port, 6, 12), (HOST, b.port, 6, 12)]
    store = _store(p0, 0, 6, peers, replication_factor=2, probe_interval=0.05,
                   quarantine_base_s=0.05, quarantine_cap_s=0.2)
    restarted = None
    try:
        got = store.fetch([6, 7])
        for i, s in zip((6, 7), got):
            np.testing.assert_array_equal(s.x, samples[i].x)
        first = store._health_table.order(store._owners(8), rot=store._rot)[0]
        (a if store.peers[first][1] == a.port else b).close()
        with pytest.warns(UserWarning, match="quarantined"):
            got = store.fetch(list(range(8, 12)))
        for i, s in zip(range(8, 12), got):
            tpu.assert_samples_equal([s], [PackedDataset(p1)[i - 6]], f"index {i}")
        st = store.stats()
        assert st["failover_fetches"] >= 1 and st["quarantine_events"] == 1
        assert st["quarantined_peers"] == 1
        port = store.peers[first][1]
        restarted = ShardServer(PackedDataset(p1), 6, 12, host=HOST, port=port)
        deadline = time.monotonic() + 5.0
        while store.stats()["quarantined_peers"] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert store.stats()["quarantined_peers"] == 0
    finally:
        store.close()
        for srv in (a, b, restarted):
            if srv is not None:
                srv.close()
    for srv in (a, b, restarted, store.server):
        srv._thread.join(TIMEOUT)
        assert not srv._thread.is_alive()
    assert not any(t.name == "hydragnn-shard-prober" for t in threading.enumerate())


def test_concurrent_fetches_lose_no_count_and_no_sample(tmp_path):
    """Sixteen threads (more than the cores) fetching overlapping remote
    batches under a short switch interval: every sample is right, the
    cache stays within its size, and ``remote_fetches`` equals the samples
    the server sent (a lost update of the counter would break it)."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    samples, (p0, p1), _ = _shards(tmp_path, 40, [8], seed=13)

    class Counting(ShardServer):
        def __init__(self, *a, **kw):
            self.sent, self.lock = 0, threading.Lock()
            super().__init__(*a, **kw)

        def handle_frame(self, z):
            with self.lock:
                self.sent += len(z.get("idx", ()))
            return super().handle_frame(z)

    srv = Counting(PackedDataset(p1), 8, 40, host=HOST)
    store = _store(p0, 0, 8, [(HOST, 0, 0, 8), (HOST, srv.port, 8, 40)], cache_size=12)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 40, size=6) for _ in range(64)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as ex:
            results = list(ex.map(store.fetch, batches, timeout=60))
    finally:
        sys.setswitchinterval(switch)
        store.close()
        srv.close()
    for idx, got in zip(batches, results):
        for i, s in zip(idx, got):
            np.testing.assert_array_equal(s.x, samples[i].x)
    assert len(store._cache) <= 12
    assert store.remote_fetches == srv.sent > 0


def test_configuration_and_refusals(tmp_path):
    """No ``peers`` and no process group: the store is its own only peer
    (the address exchange over ``torch.distributed``,
    ``tests/test_torch_parallel.py``, gives it the others), and a range it
    does not cover refuses the store; a gap in the ranges, a shard of the
    wrong size; ``apply_config`` takes the ``Dataset.store`` block but keeps
    explicit arguments; an under-replicated range warns; a refused store
    leaves no server running."""
    _, (p0, p1), _ = _shards(tmp_path, 12, [6], seed=1)
    before = set(threading.enumerate())
    alone = ShardedStore(p0, 0, 6, bind_host=HOST, advertise_host=HOST)
    try:
        assert alone.peers == [(HOST, alone.server.port, 0, 6)] and alone.total == 6
    finally:
        alone.close()
    with pytest.raises(ValueError, match="unserved"):
        ShardedStore(p1, 6, 12, bind_host=HOST, advertise_host=HOST)
    with pytest.raises(ValueError, match="holds 6 samples"):
        _store(p0, 0, 5, [(HOST, 0, 0, 5)])
    with pytest.raises(ValueError, match="unserved"):
        _store(p0, 0, 6, [(HOST, 0, 0, 6), (HOST, 1, 8, 12)])
    assert [t for t in set(threading.enumerate()) - before if "_serve" in t.name] == []
    store = _store(p0, 0, 6, [(HOST, 0, 0, 6), (HOST, 1, 6, 12)])
    try:
        block = dict(store_config_defaults(), peer_timeout=2.5, probe_interval=0.5)
        store.apply_config(block)
        assert store.peer_timeout == TIMEOUT and store.probe_interval == 0.5
        assert store._rt.timeout == TIMEOUT
        with pytest.warns(UserWarning, match="replication_factor=2"):
            store.apply_config(dict(block, replication_factor=2))
    finally:
        store.close()


def test_run_training_applies_the_store_block(tmp_path, monkeypatch):
    """``run_training`` hands the ``Dataset.store`` block to a store passed as
    the samples before its data prologue reads it."""
    import copy

    from hydragnn_tpu_torch import run_training
    from test_config import CI_CONFIG

    _, (p0, p1), _ = _shards(tmp_path, 20, [12])
    srv = ShardServer(PackedDataset(p1), 12, 20, host=HOST)
    store = ShardedStore(p0, 0, 12, peers=[(HOST, 0, 0, 12), (HOST, srv.port, 12, 20)],
                         bind_host=HOST)
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["Dataset"]["store"] = {"peer_timeout": 4.0, "probe_interval": 0.25}
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 1
    try:
        state, _, _ = run_training(cfg, samples=store, device="cpu", path=str(tmp_path))
        assert store.peer_timeout == 4.0 and store.probe_interval == 0.25
        assert state.step > 0 and store.remote_fetches == 8
    finally:
        store.close()
        srv.close()


def test_port_store_reads_from_a_jax_shard_server(tmp_path):
    samples, (p0, p1), _ = _shards(tmp_path, 12, [5], seed=11)
    jsrv = JaxServer(JaxPacked(p1), 5, 12, host=HOST, auth_token="tok")
    store = _store(p0, 0, 5, [(HOST, 0, 0, 5), (HOST, jsrv.port, 5, 12)], auth_token="tok")
    try:
        got = store.fetch(list(range(12)))
        want = PackedDataset(p0).load_all() + JaxPacked(p1).load_all()
        tpu.assert_samples_equal(got, want, "port client, JAX server")
        np.testing.assert_array_equal(store.sample_sizes(range(12)),
                                      [(s.num_nodes, s.num_edges) for s in samples])
    finally:
        store.close()
        jsrv.close()


def test_jax_store_reads_from_a_port_shard_server(tmp_path):
    samples, (p0, p1), _ = _shards(tmp_path, 12, [5], seed=12)
    for p in (p0, p1):  # the JAX writer's files: the same bytes
        JaxWriter(JaxPacked(p).load_all(), p + ".j")
        assert open(p, "rb").read() == open(p + ".j", "rb").read()
    psrv = ShardServer(PackedDataset(p1), 5, 12, host=HOST)
    jstore = JaxStore(p0, 0, 5, peers=[(HOST, 0, 0, 5), (HOST, psrv.port, 5, 12)],
                      bind_host=HOST, peer_timeout=TIMEOUT)
    try:
        got = jstore.fetch(list(range(12)))
        want = JaxPacked(p0).load_all() + PackedDataset(p1).load_all()
        tpu.assert_samples_equal(got, want, "JAX client, port server")
        np.testing.assert_array_equal(jstore.sample_sizes(range(12))[5:],
                                      [(s.num_nodes, s.num_edges) for s in samples[5:]])
    finally:
        jstore.close()
        psrv.close()
