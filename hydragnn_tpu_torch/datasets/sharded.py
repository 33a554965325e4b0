"""Non-shared-filesystem data plane: per-host packed shards + TCP sample
exchange — the role of the reference's DDStore
(``hydragnn/utils/datasets/distdataset.py:72-367``: each rank materializes
only its window and serves remote ``get()`` fetches over MPI RMA windows).

Counterpart of ``hydragnn_tpu/datasets/sharded.py`` over the port's
``utils/wire.py``, whose frames are the JAX package's bytes: a port client
reads from a JAX ``ShardServer`` and a JAX client from a port one.

``GlobalShuffleStore`` (``packed.py``) assumes every host can mmap the SAME
packed file. When each host instead holds only its own shard on local disk,
``ShardedStore`` fills the gap:

* host ``h`` owns global indices ``[start_h, stop_h)`` backed by its local
  ``PackedDataset`` shard;
* a per-host ``ShardServer`` thread answers batched index fetches over TCP
  (one request per owner per batch);
* the address book (host, port, index range) is passed explicitly
  (``peers=``) or, without it, exchanged among the processes of the
  ``torch.distributed`` group (``all_gather_object``, the JAX package's
  ``process_allgather``); a process without a group is its own only peer;
* reads of any global index then work from every host: local → zero-copy
  mmap, remote → fetch + bounded LRU cache.

Feed the store straight to ``GraphLoader(..., rank, world, shuffle=True)``:
each host's per-epoch stride of the shared global permutation spans the
WHOLE corpus, fetching the ~(world-1)/world non-local samples from their
owners.

Replication and failover: peer ranges may OVERLAP — with
``replication_factor=R`` every range is served by R owners holding mirror
shards; a dead or slow owner fails over to a replica instead of stalling
the epoch; dead peers are quarantined with a doubling re-probe backoff (a
background prober pings them and lifts the quarantine when the host
returns); a watchdog deadline brackets every replica round-trip so even a
byte-dribbling peer cannot park an epoch. Only transport faults fail over;
protocol errors (auth mismatch, misroute, server-side exception) stay loud.

The wire format is the length-prefixed binary array framing of
``utils/wire.py`` (no pickle; object dtypes refused on both ends). The
optional ``auth_token`` and bindable listen interface protect against
MISCONFIGURATION (two jobs sharing a fabric, a peer dialing the wrong
port), not against a network attacker: the token travels plaintext.

The round-trips' deadlines are the resilience layer's ``Watchdog``
(``resilience/watchdog.py``, through ``utils/wire.py``): one monitor thread,
a table of concurrent guards, and a per-guard ``on_expire`` that severs the
wedged socket. Every live ``ShardServer`` of the process is in a registry
(:func:`live_servers`, creation order) that the fault plan's ``dead_shard``
and ``slow_peer`` drills address (``resilience/chaos.py``).

Telemetry, as in the JAX module: ``store_remote_fetches_total``,
``store_failover_fetches_total`` and ``store_quarantine_events_total``
count beside :meth:`ShardedStore.stats` (whose numbers are published as
``sharded_store_*`` gauges), a peer going down is a ``failover`` record,
and with trace propagation on each replicated request runs under one
``request_id`` (the ambient one or a fresh one), each hop a ``store_hop``
child record (and, with trace events on, a ``store_hop:<peer>`` span)
naming the peer it tried, which sees the same id in its own journal.

The JAX module's ``HYDRAGNN_REPLICATION`` / ``HYDRAGNN_PEER_TIMEOUT`` /
``HYDRAGNN_STORE_RETRIES`` overrides are not ported yet; their knobs here
are the constructor's and ``Dataset.store``'s.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time
import warnings
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import telemetry as tel
from ..graphs.graph import GraphSample
from ..utils.retry import RetryPolicy
from ..utils.wire import (
    HealthTable,
    RoundTripper,
    WireServer,
    check_pong,
    copy_sample,
    encode_samples,
    samples_from_frame,
    unpack_arrays,
)
from .packed import PackedDataset, pad_spec_from_stats

# the fetch path's retry policy: the JAX package's HYDRAGNN_STORE_RETRIES
# default (3 attempts, exponential backoff with jitter)
STORE_POLICY = RetryPolicy(attempts=3)


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """The store's knobs; these field defaults ARE the ``Dataset.store``
    config defaults (``config.update_config`` fills the block from
    ``store_config_defaults``) and the ``ShardedStore`` constructor
    defaults.

    * ``replication_factor`` — owners expected per sample range; R > 1 lets
      ``fetch`` fail over to a live replica and quarantine a dead peer.
    * ``peer_timeout`` — connect/read deadline per peer socket; a peer
      slower than this IS down for failover purposes.
    * ``probe_interval`` — how often the background prober re-pings
      quarantined peers.
    * ``quarantine_base_s``/``quarantine_cap_s`` — the re-probe backoff:
      each consecutive failed probe doubles the quarantine, up to the cap.
    """

    replication_factor: int = 1
    peer_timeout: float = 120.0
    probe_interval: float = 2.0
    quarantine_base_s: float = 1.0
    quarantine_cap_s: float = 30.0


def store_config_defaults() -> dict:
    """``{config key: default}`` for the ``Dataset.store`` block: every
    ``StoreConfig`` field."""
    return {f.name: f.default for f in dataclasses.fields(StoreConfig)}


_LIVE_LOCK = threading.Lock()
_LIVE: list = []  # guarded-by: _LIVE_LOCK


def live_servers() -> "list[ShardServer]":
    """This process's live ``ShardServer``s, in creation order (the chaos
    drills' ``peer`` index)."""
    with _LIVE_LOCK:
        return list(_LIVE)


class ShardServer(WireServer):
    """Threaded TCP server answering batched sample fetches from the local
    shard. Request: a ``pack_arrays`` frame {"idx": int64[k] LOCAL indices,
    "range": [start, stop] the GLOBAL range the client believes this server
    owns}; response: the encoded samples, or an error record (``n`` -1 and
    the range it has) when the range does not match — a misrouted
    connection must fail loudly, not serve wrong samples. A frame with
    ``sizes`` asks for the shard's (num_nodes, num_edges) table.

    ``host`` restricts the listening interface; ``auth_token`` adds a
    per-request shared-secret check (``n`` -2 on mismatch). ``port`` 0 picks
    an ephemeral port; a fixed port lets a restarted host come back at the
    address its peers advertise."""

    def __init__(self, ds: PackedDataset, start: int, stop: int, host: str = "0.0.0.0",
                 auth_token: str | None = None, port: int = 0):
        self.ds = ds
        self.start, self.stop = int(start), int(stop)
        super().__init__(host=host, port=port, auth_token=auth_token, name="ShardServer")
        with _LIVE_LOCK:
            _LIVE.append(self)

    def close(self) -> None:
        with _LIVE_LOCK:
            if self in _LIVE:
                _LIVE.remove(self)
        super().close()

    def pong_fields(self) -> dict:
        # the prober checks it is talking to the peer it thinks it is
        return {"have": np.asarray([self.start, self.stop], np.int64)}

    def handle_frame(self, z: dict) -> bytes | dict:
        want = z.get("range")
        if want is not None and (int(want[0]) != self.start or int(want[1]) != self.stop):
            return {"n": np.asarray(-1, np.int64),
                    "have": np.asarray([self.start, self.stop], np.int64)}
        if "sizes" in z:
            return {"n": np.asarray(0, np.int64),
                    "sizes": self.ds.sample_sizes(range(self.stop - self.start))}
        return encode_samples([self.ds[int(i)] for i in z["idx"]])


class ShardedStore:
    """Global-index Sequence over per-host shards (see the module
    docstring).

    ``peers``: list over ranks of ``(host, port, start, stop)``, this host's
    own entry included (its port may be 0: the store's own server). A
    remote fetch walks a range's owners healthy-first, rotated per client;
    a transport failure quarantines the peer and fails over to the next
    replica; a background prober lifts the quarantine when the peer
    answers a ping with the range it is listed for."""

    def __init__(
        self,
        shard_path: str,
        start: int,
        stop: int,
        peers: list[tuple[str, int, int, int]] | None = None,
        cache_size: int = 4096,
        bind_host: str = "0.0.0.0",
        auth_token: str | None = None,
        max_idle_conns_per_peer: int = 4,
        replication_factor: int | None = None,
        peer_timeout: float | None = None,
        probe_interval: float | None = None,
        quarantine_base_s: float | None = None,
        quarantine_cap_s: float | None = None,
        advertise_host: str | None = None,
    ):
        self.ds = PackedDataset(shard_path)
        if len(self.ds.subset) != stop - start:
            raise ValueError(f"shard {shard_path} holds {len(self.ds.subset)} samples but "
                             f"claims global range [{start}, {stop})")
        self.start, self.stop = int(start), int(stop)
        server = None
        if peers is None:
            # the exchange advertises this store's server: it starts first
            server = ShardServer(self.ds, start, stop, host=bind_host, auth_token=auth_token)
            try:
                peers = self._allgather_peers(server.port, advertise_host)
            except BaseException:
                _stop(server)
                raise
        try:
            self._set_peers(peers)
        except BaseException:
            if server is not None:
                _stop(server)
            raise
        # started once the ranges are valid: a refused store leaves no server
        self.server = server or ShardServer(self.ds, start, stop, host=bind_host,
                                            auth_token=auth_token)

        # knobs: constructor-explicit arg > Dataset.store block
        # (apply_config) > StoreConfig default; explicit args are
        # remembered, so a later schema-filled block cannot clobber them
        explicit = dict(replication_factor=replication_factor, peer_timeout=peer_timeout,
                        probe_interval=probe_interval, quarantine_base_s=quarantine_base_s,
                        quarantine_cap_s=quarantine_cap_s)
        self._explicit_cfg = {k for k, v in explicit.items() if v is not None}
        for key, default in store_config_defaults().items():
            val = explicit[key]
            setattr(self, key, type(default)(default if val is None else val))
        self._check_replication()
        # deterministic per-client replica rotation: clients prefer
        # different replicas, so replicated reads spread
        self._rot = (self.start * 2654435761 + self.stop) % (1 << 31)
        self._rt = RoundTripper(self.peer_timeout, auth_token=auth_token,
                                max_idle_per_peer=max_idle_conns_per_peer)
        # the lock guards only cache and counter bookkeeping; round-trips run
        # outside it, so concurrent fetches overlap
        self._lock = threading.Lock()
        self._cache: OrderedDict[int, GraphSample] = OrderedDict()  # guarded-by: _lock
        self._cache_size = int(cache_size)
        self._sizes: np.ndarray | None = None  # guarded-by: _sizes_lock
        self._sizes_lock = threading.Lock()
        self._executor: ThreadPoolExecutor | None = None  # guarded-by: _lock
        self.remote_fetches = 0  # guarded-by: _lock
        self.failover_fetches = 0  # guarded-by: _lock
        self.quarantine_events = 0  # guarded-by: _lock
        self._health_table = HealthTable(self.quarantine_base_s, self.quarantine_cap_s)
        self._probe_stop = threading.Event()
        self._probe_thread: threading.Thread | None = None

    def _set_peers(self, peers) -> None:
        """Sorted peers; the union of their spans must cover [0, total)
        with no gap (overlaps, replicas, are the feature; gaps are fatal)."""
        self.peers = sorted(peers, key=lambda p: (p[2], p[3]))
        self.total = max(p[3] for p in self.peers)
        cursor = 0
        spans = sorted({(p[2], p[3]) for p in self.peers})
        for s0, s1 in spans:
            if s0 > cursor:
                raise ValueError(f"shard ranges leave [{cursor}, {s0}) unserved: {spans}")
            cursor = max(cursor, s1)

    def _allgather_peers(self, port: int, advertise_host: str | None):
        """Every process's (host, port, start, stop), exchanged over the
        ``torch.distributed`` group (this process's own entry alone without
        one)."""
        import torch.distributed as dist

        host = advertise_host or socket.gethostbyname(socket.gethostname())
        mine = (host, int(port), self.start, self.stop)
        if not (dist.is_available() and dist.is_initialized()):
            return [mine]
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, mine)
        return out

    @property
    def _pool(self):
        return self._rt.pool

    @property
    def _health(self) -> dict:
        return self._health_table.entries

    def apply_config(self, cfg: dict) -> None:
        """Apply a ``Dataset.store`` block (schema-filled defaults) to a live
        store: ``run_training`` calls this, so a store built before the
        config was loaded still honours it. Knobs set explicitly at
        construction are kept."""
        for key in store_config_defaults():
            if key in self._explicit_cfg:
                continue
            if cfg.get(key) is not None:
                setattr(self, key, type(getattr(self, key))(cfg[key]))
        self._rt.timeout = self.peer_timeout
        self._health_table.base_s = self.quarantine_base_s
        self._health_table.cap_s = self.quarantine_cap_s
        self._check_replication()

    def _check_replication(self) -> None:
        """Warn when an elementary range has fewer owners than the
        replication factor: it is one host loss away from stalling."""
        if self.replication_factor <= 1:
            return
        bounds = sorted({b for p in self.peers for b in (p[2], p[3])})
        worst, where = None, None
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            n = sum(1 for p in self.peers if p[2] <= lo and hi <= p[3])
            if worst is None or n < worst:
                worst, where = n, (lo, hi)
        if worst is not None and worst < self.replication_factor:
            warnings.warn(
                f"range [{where[0]}, {where[1]}) has {worst} owner(s) but "
                f"replication_factor={self.replication_factor} — a single host loss can "
                "stall fetches for under-replicated ranges")

    # -- Sequence API --------------------------------------------------------
    def __len__(self) -> int:
        return self.total

    @property
    def attrs(self) -> dict:
        return self.ds.attrs

    def _is_self(self, rank: int) -> bool:
        _, port, s0, s1 = self.peers[rank]
        return s0 == self.start and s1 == self.stop and port in (0, self.server.port)

    def _owners(self, i: int) -> tuple[int, ...]:
        """Every REMOTE peer rank whose span contains global index ``i``:
        the replica set a fetch may fail over across."""
        ranks = tuple(rank for rank, (_, _, s0, s1) in enumerate(self.peers)
                      if s0 <= i < s1 and not self._is_self(rank))
        if not ranks and not (self.start <= i < self.stop):
            raise IndexError(i)
        return ranks

    # -- peer health / quarantine -------------------------------------------
    def _mark_peer_down(self, rank: int, err: BaseException, failover: bool) -> None:
        """Quarantine a peer after a transport failure: evict its pooled
        sockets, arm the re-probe backoff, wake the prober."""
        host, port, s0, s1 = self.peers[rank]
        announce = self._health_table.bump(rank)
        self._pool.evict(rank)
        if announce:
            with self._lock:
                self.quarantine_events += 1
            tel.counter("store_quarantine_events_total").inc()
            tel.emit("failover", peer=rank, host=host, port=port, error=type(err).__name__,
                     has_replica=bool(failover))
            warnings.warn(
                f"shard peer {host}:{port} (range [{s0}, {s1})) is down "
                f"({type(err).__name__}: {err}): quarantined"
                + (", failing over to a replica" if failover else
                   " — range has NO live replica; fetches keep attempting it"))
        self._ensure_prober()

    def _mark_peer_up(self, rank: int, announce: bool = False) -> None:
        was = self._health_table.lift(rank)
        if was is not None and announce:
            host, port, s0, s1 = self.peers[rank]
            warnings.warn(f"shard peer {host}:{port} (range [{s0}, {s1})) answers again after "
                          f"{was['failures']} failed probe(s): quarantine lifted")

    def stats(self) -> dict:
        """Remote and failover fetch totals, peer-down events, cache
        occupancy and the quarantine census."""
        with self._lock:
            out = {"remote_fetches": self.remote_fetches,
                   "failover_fetches": self.failover_fetches,
                   "quarantine_events": self.quarantine_events,
                   "cache_entries": len(self._cache), "cache_size": self._cache_size}
        with self._health_table.lock:
            out["quarantined_peers"] = len(self._health)
        out["peers"] = len(self.peers)
        tel.publish("sharded_store", out)
        return out

    def _ensure_prober(self) -> None:
        with self._health_table.lock:
            if self._probe_thread is not None and self._probe_thread.is_alive():
                return
            if self._probe_stop.is_set():
                return
            self._probe_thread = threading.Thread(target=self._probe_loop,
                                                  name="hydragnn-shard-prober", daemon=True)
            self._probe_thread.start()

    def _probe_loop(self) -> None:
        """Re-probe quarantined peers (one daemon thread, alive while
        something is quarantined): ping, and lift the quarantine when the
        peer answers with the range it is listed for."""
        while not self._probe_stop.wait(self.probe_interval):
            with self._health_table.lock:
                if not self._health:
                    # clearing the handle under the lock closes the race
                    # with _ensure_prober
                    self._probe_thread = None
                    return
                now = time.monotonic()
                due = [r for r, h in self._health.items() if now >= h["until"]]
            for rank in due:
                host, port, s0, s1 = self.peers[rank]
                try:
                    z = self._rt.round_trip(rank, host, port, policy=RetryPolicy(attempts=1),
                                            what=f"probe of shard peer {host}:{port}",
                                            ping=np.asarray(1, np.int64))
                    check_pong(z, f"probe of shard peer {host}:{port}", have=[s0, s1])
                except (ConnectionError, OSError, ValueError):
                    self._health_table.bump(rank)
                    continue
                self._mark_peer_up(rank, announce=True)

    def _failover_request(self, owner_ranks, fields_for, what: str):
        """One replicated request: walk the replica set healthy-first, one
        attempt per replica per round; a transport failure quarantines the
        peer and moves on; only when every replica failed does a round end,
        sleeping per ``STORE_POLICY`` before the next. Protocol errors
        raise at once. Returns ``(decoded frame, rank, s0, s1)`` of the
        replica that answered; ``fields_for(s0, s1)`` builds the request for
        an owner advertising ``[s0, s1)``. With trace propagation on, the
        walk runs under one ``request_id`` and journals a ``store_hop``
        record per peer tried."""
        if not tel.propagate_enabled():
            return self._failover_walk(owner_ranks, fields_for, what, False)
        rid = tel.get_context().get("request_id") or tel.new_request_id()
        with tel.scoped_context(request_id=rid):
            return self._failover_walk(owner_ranks, fields_for, what, True)

    def _hop(self, hop: int, rank: int, t0_wall: float, outcome: str, **fields) -> None:
        """One traced hop's ``store_hop`` record (and span)."""
        host, port = self.peers[rank][:2]
        tel.emit("store_hop", hop=hop, peer=rank, host=host, port=port, outcome=outcome,
                 **fields)
        if tel.trace_enabled():
            tel.add_span(f"store_hop:{rank}", t0_wall, time.time() - t0_wall,
                         args={"peer": rank, "outcome": outcome})

    def _failover_walk(self, owner_ranks, fields_for, what: str, traced: bool):
        policy = STORE_POLICY
        hop = 0
        last_err: BaseException | None = None
        failed_over = False
        for rnd in range(policy.attempts):
            if rnd:
                sleep_s = policy.delay(rnd)
                warnings.warn(f"{what}: every replica failed ({type(last_err).__name__}: "
                              f"{last_err}); retry round {rnd}/{policy.attempts - 1} in "
                              f"{sleep_s:.2f}s")
                time.sleep(sleep_s)
            order = self._health_table.order(owner_ranks, rot=self._rot)
            for rank in order:
                host, port, s0, s1 = self.peers[rank]
                t0_wall = time.time()
                try:
                    z = self._rt.round_trip(rank, host, port, policy=RetryPolicy(attempts=1),
                                            what=f"shard round-trip to {host}:{port}",
                                            **fields_for(s0, s1))
                except (ConnectionError, OSError) as e:
                    last_err = e
                    failed_over = True
                    if traced:
                        self._hop(hop, rank, t0_wall, "quarantined", error=type(e).__name__)
                    hop += 1
                    self._mark_peer_down(rank, e, failover=len(order) > 1)
                    continue
                self._check_status(z, host, port, s0, s1)
                self._mark_peer_up(rank)
                if traced:
                    self._hop(hop, rank, t0_wall, "served", failed_over=bool(failed_over),
                              dur_s=round(time.time() - t0_wall, 6))
                if failed_over:
                    n = max(int(z.get("n", np.asarray(0))), 0)
                    with self._lock:
                        self.failover_fetches += n
                    tel.counter("store_failover_fetches_total").inc(n)
                return z, rank, s0, s1
        raise ConnectionError(
            f"{what}: all {len(owner_ranks)} replica(s) failed after {policy.attempts} "
            f"round(s); last error: {type(last_err).__name__}: {last_err}")

    @staticmethod
    def _check_status(z: dict[str, np.ndarray], host: str, port: int, s0: int, s1: int):
        n = int(z["n"])
        if n == -3:
            detail = bytes(np.asarray(z.get("detail", []), np.uint8)).decode(errors="replace")
            raise RuntimeError(f"shard server at {host}:{port} failed serving the request: "
                               f"{detail or 'unknown error'}")
        if n == -2:
            raise RuntimeError(f"shard fetch rejected by {host}:{port}: auth token mismatch "
                               "(pass the same auth_token on every host)")
        if n == -1:
            raise RuntimeError(
                f"shard fetch misrouted: peer at {host}:{port} owns global range "
                f"{z.get('have', '?')}, expected [{s0}, {s1}) — check the advertised "
                "addresses (loopback hostnames on multi-host clusters are the usual cause)")

    def __getitem__(self, i) -> GraphSample:
        i = int(i)
        if self.start <= i < self.stop:
            return self.ds[i - self.start]
        return self.fetch([i])[0]

    def sample_sizes(self, indices) -> np.ndarray:
        """[k, 2] (num_nodes, num_edges) for GLOBAL indices. The whole size
        table is exchanged once (one request per span), so bucket planning
        never turns into per-sample content fetches."""
        if self._sizes is None:
            with self._sizes_lock:
                if self._sizes is None:
                    self._sizes = self._fetch_all_sizes()
        return self._sizes[np.asarray(indices, np.int64)]

    def _fetch_all_sizes(self) -> np.ndarray:
        out = np.zeros((self.total, 2), np.int64)
        covered = np.zeros(self.total, bool)
        out[self.start:self.stop] = self.ds.sample_sizes(range(self.stop - self.start))
        covered[self.start:self.stop] = True
        by_span: dict[tuple[int, int], list[int]] = {}
        for rank, (_, _, s0, s1) in enumerate(self.peers):
            if not self._is_self(rank):
                by_span.setdefault((s0, s1), []).append(rank)
        errors: list[str] = []
        for (s0, s1), ranks in sorted(by_span.items()):
            if covered[s0:s1].all():
                continue  # a mirror of a span already served
            try:
                z, _, a0, a1 = self._failover_request(
                    ranks, lambda a0, a1: dict(idx=np.zeros((0,), np.int64),
                                               range=np.asarray([a0, a1], np.int64),
                                               sizes=np.asarray(1, np.int64)),
                    what=f"size table for range [{s0}, {s1})")
            except (ConnectionError, OSError) as e:
                # a finer span of another replica may still cover it
                errors.append(f"[{s0}, {s1}): {e}")
                continue
            out[a0:a1] = z["sizes"]
            covered[a0:a1] = True
        if not covered.all():
            lo = int(np.argmin(covered))
            raise ConnectionError(f"size table incomplete: no live owner covers index {lo} "
                                  f"(failed spans: {'; '.join(errors) or 'none'})")
        return out

    def _fan_out(self, fetch_owner, by_owner: dict) -> list:
        """One round-trip per replica set; concurrent on a persistent pool
        when a batch touches several."""
        if len(by_owner) <= 1:
            return [fetch_owner(it) for it in by_owner.items()]
        with self._lock:
            if self._executor is None:
                # sized for concurrent callers (prefetch workers each
                # fanning out to several owners), not for one fetch
                self._executor = ThreadPoolExecutor(16)
            executor = self._executor
        return list(executor.map(fetch_owner, by_owner.items()))

    def _owner_fetch(self, verb: str):
        def fetch_owner(item):
            ranks, idxs = item
            z, _, _, _ = self._failover_request(
                ranks, lambda a0, a1: dict(idx=np.asarray([i - a0 for i in idxs], np.int64),
                                           range=np.asarray([a0, a1], np.int64)),
                what=f"{verb} of {len(idxs)} sample(s) from range [{min(idxs)}, {max(idxs)}]")
            return idxs, samples_from_frame(z)
        return fetch_owner

    def _ordered(self, indices, out: dict) -> list[GraphSample]:
        """``out`` in the order of ``indices``; a repeated REMOTE index gets
        its own copy (writable instances are never shared); local read-only
        mmap views are safe to share."""
        result: list[GraphSample] = []
        emitted: set[int] = set()
        for i in map(int, indices):
            s = out[i]
            if i in emitted and not (self.start <= i < self.stop):
                s = copy_sample(s)
            else:
                emitted.add(i)
            result.append(s)
        return result

    def fetch(self, indices) -> list[GraphSample]:
        """Batched read of GLOBAL indices: local ones from mmap, remote ones
        with one request per replica set, through the LRU cache.

        LOCAL samples are zero-copy READ-ONLY mmap views; REMOTE samples are
        independent writable copies (the cache keeps its own pristine
        instance, so a caller changing one never changes a later hit)."""
        out: dict[int, GraphSample] = {}
        by_owner: dict[tuple[int, ...], list[int]] = {}
        remote: list[int] = []
        for i in map(int, indices):
            if self.start <= i < self.stop:
                out[i] = self.ds[i - self.start]
            else:
                remote.append(i)
        if remote:
            pending: set[int] = set()
            hits: dict[int, GraphSample] = {}
            with self._lock:
                for i in remote:
                    if i in self._cache:
                        self._cache.move_to_end(i)
                        hits[i] = self._cache[i]
                    elif i not in pending:
                        pending.add(i)
                        # grouped by replica set: one dead host re-routes
                        # the whole request
                        by_owner.setdefault(self._owners(i), []).append(i)
            # the copy on a hit runs outside the lock
            for i, s in hits.items():
                out[i] = copy_sample(s)
        for idxs, samples in self._fan_out(self._owner_fetch("fetch"), by_owner):
            cache_copies = [copy_sample(s) for s in samples]
            tel.counter("store_remote_fetches_total").inc(len(samples))
            with self._lock:
                self.remote_fetches += len(samples)
                for i, s, c in zip(idxs, samples, cache_copies):
                    out[i] = s
                    self._cache[i] = c
                while len(self._cache) > self._cache_size:
                    self._cache.popitem(last=False)
        return self._ordered(indices, out)

    def fetch_many(self, indices) -> list[GraphSample]:
        """Bulk streaming read: the same grouping and failover as
        :meth:`fetch`, but BYPASSING the LRU cache (a sweep touches each
        sample once: a hit could never pay back its copy, and the sweep
        would evict the working set the cache is for)."""
        out: dict[int, GraphSample] = {}
        by_owner: dict[tuple[int, ...], list[int]] = {}
        for i in map(int, indices):
            if self.start <= i < self.stop:
                out[i] = self.ds[i - self.start]
            elif i not in out:
                out[i] = None  # placeholder: dedup
                by_owner.setdefault(self._owners(i), []).append(i)
        n_remote = 0
        for idxs, samples in self._fan_out(self._owner_fetch("bulk fetch"), by_owner):
            n_remote += len(samples)
            out.update(zip(idxs, samples))
        if n_remote:
            tel.counter("store_remote_fetches_total").inc(n_remote)
            with self._lock:
                self.remote_fetches += n_remote
        return self._ordered(indices, out)

    def pad_spec(self, batch_size: int, node_multiple: int = 8, edge_multiple: int = 128):
        """PadSpec from the shard's writer stats, their maxima taken across
        the processes of the ``torch.distributed`` group (the stats are
        per shard; every process must pad to one shape)."""
        import torch.distributed as dist

        attrs = dict(self.attrs)
        if "max_nodes" not in attrs:
            raise ValueError("packed shard lacks size stats; re-write with PackedWriter")
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            out = [None] * dist.get_world_size()
            dist.all_gather_object(out, (int(attrs["max_nodes"]), int(attrs["max_edges"])))
            attrs["max_nodes"] = max(o[0] for o in out)
            attrs["max_edges"] = max(o[1] for o in out)
        return pad_spec_from_stats(attrs, batch_size, node_multiple, edge_multiple)

    def loader(self, batch_size: int, rank: int = 0, world: int = 1, seed: int = 0,
               shuffle: bool = True, pad=None, **kw):
        from ..graphs.batching import GraphLoader

        return GraphLoader(self, batch_size, pad=pad or self.pad_spec(batch_size),
                           shuffle=shuffle, seed=seed, rank=rank, world=world, **kw)

    def close(self, timeout: float = 5.0) -> None:
        """Stop the prober, the shard server, the fan-out pool and the pooled
        sockets; waits up to ``timeout`` seconds for the prober thread."""
        self._probe_stop.set()
        _stop(self.server, timeout)
        if self._executor is not None:
            self._executor.shutdown(wait=False)
        self._pool.close()
        thread = self._probe_thread
        if thread is not None:
            thread.join(timeout)


def _stop(server, timeout: float = 5.0) -> None:
    """Close a shard server and wait for its accept thread."""
    server.close()
    thread = getattr(server, "_thread", None)
    if thread is not None:
        thread.join(timeout)


__all__ = ["STORE_POLICY", "ShardServer", "ShardedStore", "StoreConfig", "live_servers",
           "store_config_defaults"]
