"""The wire transport of the serving fleet and the sharded sample store.

Counterpart of ``hydragnn_tpu/utils/wire.py``, byte for byte in what goes
over a socket, so a frame of the port and a frame of the JAX package for
the same sample are the same bytes:

* **framing + codec** — ``send_msg``/``recv_msg`` length-prefixed frames of
  ``pack_arrays`` dict-of-ndarray payloads (no pickle: object dtypes are
  refused on both ends; zero-copy ``np.frombuffer`` decode, every length
  validated before slicing);
* **sample codec** — ``GraphSample`` <-> flat array dict (the fleet's
  predict request payload and the sharded store's fetch payload), and
  ``copy_sample``;
* **auth** — ``token_field``/``token_ok``: a shared-secret
  misconfiguration guard (plaintext and replayable), compared with
  ``hmac.compare_digest``;
* **ping/pong** — ``pong_frame`` (server) and ``check_pong`` (client);
* **ConnPool / RoundTripper** — pooled per-peer sockets with the
  stale-pool retry discipline, and a watchdog deadline around every
  round-trip, so a peer that dribbles bytes (resetting the per-``recv``
  socket timeout forever) is severed and surfaces as a connection error;
* **WireServer** — the threaded TCP server shell (connection registry,
  instant dead-host ``close()``, malformed-frame drop, auth check, ping
  answer, server-error records) that the fleet's ``ReplicaHost`` and the
  sharded store's ``ShardServer`` subclass;
* **HealthTable** — the quarantine clock (doubling re-probe backoff,
  healthy-first rotated replica ordering) of replica failover, in the
  fleet's router and the sharded store.

Trace propagation (``telemetry.propagation``), as in the JAX module:
``RoundTripper.request`` adds the optional ``_trace_ctx`` field when
propagation is armed and the ambient journal context holds a
``request_id``; ``WireServer`` enters a frame's context into the handler
thread's journal scope and journals one ``wire_serve`` record per traced
frame. The field and its JSON blob are the JAX package's, so a port peer
and a JAX peer carry one ``request_id`` both ways; with propagation off
(``HYDRAGNN_TRACE_PROPAGATE=0``, ``Telemetry.trace_propagate: false``) or
no ``request_id`` in scope a frame carries no field, byte for byte the
frame without telemetry.
"""

from __future__ import annotations

import hmac
import socket
import socketserver
import struct
import sys
import threading
import time
from contextlib import nullcontext

import numpy as np

from ..graphs.graph import GraphSample
from ..telemetry import journal as _journal, propagation as _propagation
from .retry import RetryPolicy, call_with_retries

HDR = struct.Struct("<q")  # payload byte length
MAGIC = b"GSX1"

# known op keys, most specific first: the label of a served frame's journal
# record ("frame" for an op this module has not met)
_OP_KEYS = ("predict", "stats", "metrics", "sizes", "idx")


def frame_op(z: dict) -> str:
    for key in _OP_KEYS:
        if key in z:
            return key
    return "frame"


# -- framing + array codec ----------------------------------------------------


def send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(HDR.pack(len(payload)) + payload)


def pack_arrays(d: dict[str, np.ndarray]) -> bytes:
    """dict[str, ndarray] -> compact binary frame; the dtype travels as its
    ``.str`` spec, never as a pickled object."""
    parts = [MAGIC, struct.pack("<I", len(d))]
    for k, v in d.items():
        v = np.ascontiguousarray(v)
        if v.dtype.hasobject:
            raise ValueError("object arrays are not allowed on the wire")
        name = k.encode()
        dt = v.dtype.str.encode()
        parts.append(struct.pack("<H", len(name)))
        parts.append(name)
        parts.append(struct.pack("<B", len(dt)))
        parts.append(dt)
        parts.append(struct.pack("<B", v.ndim))
        if v.ndim:
            parts.append(struct.pack(f"<{v.ndim}q", *v.shape))
        raw = v.tobytes()
        parts.append(struct.pack("<q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def unpack_arrays(buf: bytes) -> dict[str, np.ndarray]:
    """Inverse of ``pack_arrays``; arrays are zero-copy views into ``buf``.
    Any malformed frame (bad magic, truncated header, unknown dtype) raises
    ``ValueError``."""
    try:
        if buf[:4] != MAGIC:
            raise ValueError("bad wire magic (peer speaks a different protocol?)")
        mv = memoryview(buf)
        off = 4
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        out: dict[str, np.ndarray] = {}
        for _ in range(n):
            (nl,) = struct.unpack_from("<H", buf, off)
            off += 2
            if off + nl > len(buf):
                raise ValueError("truncated frame (name)")
            name = bytes(mv[off:off + nl]).decode()
            off += nl
            (dl,) = struct.unpack_from("<B", buf, off)
            off += 1
            if off + dl > len(buf):
                raise ValueError("truncated frame (dtype)")
            dt = np.dtype(bytes(mv[off:off + dl]).decode())
            off += dl
            if dt.hasobject:
                raise ValueError("object arrays are not allowed on the wire")
            (nd,) = struct.unpack_from("<B", buf, off)
            off += 1
            shape = struct.unpack_from(f"<{nd}q", buf, off) if nd else ()
            off += 8 * nd
            (nb,) = struct.unpack_from("<q", buf, off)
            off += 8
            count = int(np.prod(shape, dtype=np.int64)) if nd else 1
            if count < 0 or nb != count * dt.itemsize or off + nb > len(buf):
                raise ValueError(f"corrupt frame for array {name!r}")
            out[name] = np.frombuffer(mv[off:off + nb], dtype=dt).reshape(shape)
            off += nb
        return out
    except ValueError:
        raise
    except (struct.error, TypeError, UnicodeDecodeError) as e:
        raise ValueError(f"corrupt frame: {e}") from None


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> bytes:
    (n,) = HDR.unpack(recv_exact(sock, HDR.size))
    if n < 0 or n > (1 << 33):
        raise ValueError(f"bad message length {n}")
    return recv_exact(sock, n)


# -- text / token fields ------------------------------------------------------


def text_field(s: str) -> np.ndarray:
    """UTF-8 text as a uint8 array (the codec carries arrays only)."""
    return np.frombuffer(s.encode(), np.uint8)


def field_text(v: np.ndarray | None, default: str = "") -> str:
    if v is None:
        return default
    return bytes(np.asarray(v, np.uint8)).decode(errors="replace")


def token_field(token: str) -> np.ndarray:
    return np.frombuffer(token.encode(), np.uint8)


def token_ok(frame: dict[str, np.ndarray], token: bytes | None) -> bool:
    """Server-side auth check: True when no token is configured or the frame
    carries a matching one (``hmac.compare_digest``: no timing leak)."""
    if token is None:
        return True
    got = frame.get("token")
    return got is not None and hmac.compare_digest(np.asarray(got).tobytes(), token)


# -- GraphSample <-> flat dict of arrays --------------------------------------

_ARRAY_FIELDS = (
    "x", "pos", "senders", "receivers", "edge_attr", "edge_shifts",
    "graph_y", "node_y", "energy_y", "forces_y", "graph_attr",
)
_EXTRA_FIELDS = ("node_table", "graph_table")
# extras that ride the serving plane (positional encodings and triplet
# indices are part of the endpoint signature)
_WIRE_EXTRAS = ("pe", "rel_pe", "idx_kj", "idx_ji")


def sample_to_arrays(s: GraphSample) -> dict[str, np.ndarray]:
    out = {}
    for f in _ARRAY_FIELDS:
        v = getattr(s, f)
        if v is not None:
            out[f] = np.asarray(v)
    for f in _EXTRA_FIELDS + _WIRE_EXTRAS:
        if f in s.extras:
            out["extra_" + f] = np.asarray(s.extras[f])
    out["dataset_id"] = np.asarray(s.dataset_id, np.int32)
    return out


def sample_from_arrays(d: dict[str, np.ndarray]) -> GraphSample:
    # np.array: decoded frames are read-only views; samples must be writable
    kw = {f: np.array(d[f]) for f in _ARRAY_FIELDS if f in d}
    s = GraphSample(dataset_id=int(d["dataset_id"]), **kw)
    for f in _EXTRA_FIELDS + _WIRE_EXTRAS:
        if "extra_" + f in d:
            s.extras[f] = np.array(d["extra_" + f])
    return s


def copy_sample(s: GraphSample) -> GraphSample:
    """An independent copy: fresh array buffers, a fresh extras dict. A
    cache hands these out, never its own instances, since the pipeline may
    replace or write a sample's arrays."""
    out = GraphSample.__new__(GraphSample)
    for f in GraphSample.__slots__:
        v = getattr(s, f)
        if isinstance(v, np.ndarray):
            v = v.copy()
        elif f == "extras":
            v = {k: (x.copy() if isinstance(x, np.ndarray) else x) for k, x in v.items()}
        setattr(out, f, v)
    return out


def encode_samples(samples: list[GraphSample]) -> bytes:
    return pack_arrays(sample_fields(samples))


def sample_fields(samples: list[GraphSample]) -> dict[str, np.ndarray]:
    """The flat ``s{i}_*`` field layout of a samples frame, so a request can
    carry samples next to other routing fields in one frame."""
    flat: dict[str, np.ndarray] = {}
    for i, s in enumerate(samples):
        for k, v in sample_to_arrays(s).items():
            flat[f"s{i}_{k}"] = v
    flat["n"] = np.asarray(len(samples), np.int64)
    return flat


def samples_from_frame(z: dict[str, np.ndarray]) -> list[GraphSample]:
    out = []
    for i in range(int(z["n"])):
        prefix = f"s{i}_"
        out.append(sample_from_arrays(
            {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}))
    return out


# -- ping / pong --------------------------------------------------------------


def pong_frame(**fields: np.ndarray) -> bytes:
    """The server half of a health probe: ``{"n": 0, "pong": 1}`` plus the
    identity fields the prober validates."""
    out = {"n": np.asarray(0, np.int64), "pong": np.asarray(1, np.int64)}
    out.update(fields)
    return pack_arrays(out)


def check_pong(z: dict[str, np.ndarray], what: str, **expect) -> None:
    """The pong validation (client half): every ``expect`` field must be
    present and equal (after int64 coercion); anything else raises
    ``ConnectionError``, so the caller's quarantine stays armed."""
    if int(np.asarray(z.get("pong", 0)).reshape(-1)[0] if "pong" in z else 0) != 1:
        raise ConnectionError(f"{what}: peer answered without a pong")
    for key, want in expect.items():
        got = z.get(key)
        want = np.asarray(want, np.int64)
        if got is None or not np.array_equal(np.asarray(got, np.int64).reshape(-1),
                                             want.reshape(-1)):
            raise ConnectionError(
                f"{what}: pong advertises {key}="
                f"{None if got is None else np.asarray(got).tolist()}, expected {want.tolist()}"
            )


def error_frame(code: int, detail: str | None = None) -> bytes:
    fields = {"n": np.asarray(int(code), np.int64)}
    if detail:
        fields["detail"] = np.frombuffer(detail.encode()[:512], np.uint8)
    return pack_arrays(fields)


def frame_detail(z: dict[str, np.ndarray]) -> str:
    return bytes(np.asarray(z.get("detail", []), np.uint8)).decode(errors="replace")


# -- server shell -------------------------------------------------------------


class WireServer:
    """Threaded TCP server answering ``pack_arrays`` frames. For every
    request frame, in order: the test delay knob, the auth-token check
    (``n=-2`` record on mismatch), ``ping`` (``pong_frame(**self.pong_fields())``),
    then :meth:`handle_frame`; an exception out of the handler becomes an
    ``n=-3`` record telling the client what broke.

    ``close()`` stops serving like a dead host: at once, the listening
    socket and every established connection severed, so pooled client
    sockets error on reuse. ``port=0`` picks an ephemeral port.

    A frame carrying the trace-context field has its ids entered into the
    handler thread's journal scope around :meth:`handle_frame` and the
    serve journalled as ``wire_serve``; ``journal=`` routes this server's
    records to a private ``EventJournal`` (a replica's own log dir)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0, auth_token: str | None = None,
                 name: str | None = None, journal: "_journal.EventJournal | None" = None,
                 _test_delay_s: float = 0.0):
        outer = self
        tok = None if auth_token is None else auth_token.encode()

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                with outer._conns_lock:
                    # registration and close()'s snapshot share one lock: a
                    # connection is severed by close() or sees it closed here
                    if outer.closed:
                        return
                    outer._conns.add(self.request)
                try:
                    self._serve_requests()
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(self.request)

            def _serve_requests(self) -> None:
                try:
                    while True:
                        try:
                            z = unpack_arrays(recv_msg(self.request))
                        except ValueError:
                            print(f"[{outer._log_name()}] dropping peer {self.client_address}: "
                                  "malformed frame", file=sys.stderr)
                            return
                        if outer._test_delay_s:
                            time.sleep(outer._test_delay_s)
                        if not token_ok(z, tok):
                            send_msg(self.request, error_frame(-2))
                            continue
                        if "ping" in z:
                            send_msg(self.request, pong_frame(**outer.pong_fields()))
                            continue
                        ctx = _propagation.extract(z)
                        t0 = time.time()
                        with _propagation.scope(ctx):
                            try:
                                resp = outer.handle_frame(z)
                                if isinstance(resp, dict):
                                    resp = pack_arrays(resp)
                                if ctx:
                                    outer.emit_event("wire_serve", op=frame_op(z), ok=1,
                                                     dur_s=round(time.time() - t0, 6))
                            except Exception as e:
                                resp = error_frame(-3, f"{type(e).__name__}: {e}")
                                if ctx:
                                    outer.emit_event("wire_serve", op=frame_op(z), ok=0,
                                                     error=type(e).__name__,
                                                     dur_s=round(time.time() - t0, 6))
                        send_msg(self.request, resp)
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._name = name or type(self).__name__
        self._journal = journal  # private journal (None: the process's)
        self._test_delay_s = float(_test_delay_s)
        self._conns: set[socket.socket] = set()  # guarded-by: _conns_lock
        self._conns_lock = threading.Lock()
        self._srv = Server((host, int(port)), Handler)
        self.port = self._srv.server_address[1]
        self.closed = False  # guarded-by: _conns_lock

        def _serve() -> None:
            try:
                self._srv.serve_forever()
            except Exception:
                # close() severs the listening socket under the select loop;
                # the resulting EBADF is the expected way down
                if not self.closed:
                    raise

        self._thread = threading.Thread(target=_serve, daemon=True)
        self._thread.start()

    def pong_fields(self) -> dict[str, np.ndarray]:
        """Identity fields the ping answer advertises (and probers validate
        with :func:`check_pong`)."""
        return {}

    def handle_frame(self, z: dict[str, np.ndarray]) -> "bytes | dict":
        raise NotImplementedError

    def emit_event(self, kind: str, **fields) -> None:
        """Journal one record: to this server's private journal when one is
        attached, else to the process's (a no-op with the plane off; a
        telemetry failure never fails a serve)."""
        try:
            if self._journal is not None:
                if _journal.metrics.enabled():
                    self._journal.emit(kind, **fields)
            else:
                _journal.emit(kind, **fields)
        except Exception:
            pass

    def _log_name(self) -> str:
        return f"{self._name}:{self.port}"

    def set_delay(self, seconds: float) -> None:
        """Delay every response by ``seconds``: a response slower than the
        client's peer timeout makes this server a gray failure."""
        self._test_delay_s = float(seconds)

    def close(self) -> None:
        with self._conns_lock:
            if self.closed:
                return
            self.closed = True
            conns = list(self._conns)
        self._srv.server_close()  # refuses new connects from this instant
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        # reap the serve loop off-thread: shutdown() waits for its poll
        threading.Thread(target=self._srv.shutdown, daemon=True).start()


# -- client: pooled sockets + watchdog-bracketed round-trips ------------------


class ConnPool:
    """Per-peer socket pool: each concurrent caller checks out its own
    socket, runs its round-trip without a shared lock and returns it. Idle
    sockets per peer are capped; excess ones close on release."""

    def __init__(self, max_idle_per_peer: int = 4, timeout: float = 120.0):
        self._idle: dict[object, list[socket.socket]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._max_idle = int(max_idle_per_peer)
        self._closed = False  # guarded-by: _lock
        self.timeout = float(timeout)  # connect and per-recv deadline

    def acquire(self, key, host: str, port: int) -> tuple[socket.socket, bool]:
        """``(socket, from_pool)``. A pooled socket may have gone stale
        while idle: callers retry once on a fresh one. ``self.timeout``
        bounds the connect and every later recv (<= 0: no deadline)."""
        timeout = self.timeout if self.timeout and self.timeout > 0 else None
        with self._lock:
            stack = self._idle.get(key)
            while stack:
                sock = stack.pop()
                try:
                    sock.settimeout(timeout)
                except OSError:
                    continue  # closed while parked
                return sock, True
        return socket.create_connection((host, port), timeout=timeout), False

    def release(self, key, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed:
                stack = self._idle.setdefault(key, [])
                if len(stack) < self._max_idle:
                    stack.append(sock)
                    return
        try:
            sock.close()
        except OSError:
            pass

    def evict(self, key) -> None:
        """Close and drop every idle socket of ``key`` (a quarantined peer)."""
        with self._lock:
            stack = self._idle.pop(key, [])
        for sock in stack:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for stack in self._idle.values():
                for sock in stack:
                    try:
                        sock.close()
                    except OSError:
                        pass
            self._idle.clear()


class RoundTripper:
    """Pooled, token-stamped, watchdog-bracketed request/reply round-trips:
    the client half of the wire protocol.

    Requests on this transport are idempotent, so retrying is safe: a stale
    pooled socket retries at once on a fresh connection without counting an
    attempt; a fresh-connection failure retries per the ``RetryPolicy``.
    ``guard`` arms the watchdog deadline (``watchdog_factor`` x the socket
    timeout) around a round-trip; a severed socket counts as a spent
    deadline, never a stale socket to retry quietly."""

    def __init__(self, timeout: float, auth_token: str | None = None,
                 max_idle_per_peer: int = 4, watchdog_factor: float = 1.25):
        self.pool = ConnPool(max_idle_per_peer, timeout=timeout)
        self._auth_token = auth_token
        self._watchdog = None  # built at the first guarded round-trip
        self._watchdog_factor = float(watchdog_factor)

    @property
    def timeout(self) -> float:
        return self.pool.timeout

    @timeout.setter
    def timeout(self, value: float) -> None:
        self.pool.timeout = float(value)
        self._watchdog = None

    def request(self, key, host: str, port: int, *, policy: RetryPolicy,
                _sock_cell: dict | None = None, **fields) -> bytes:
        """One request/response round-trip on a pooled socket. The socket
        returns to the pool only after a clean round-trip. ``_sock_cell``
        exposes the in-flight socket to the watchdog."""
        if self._auth_token is not None:
            fields["token"] = token_field(self._auth_token)
        # the trace context rides along when armed and a request_id is in
        # scope; otherwise nothing is added
        _propagation.inject(fields)
        req = pack_arrays(fields)

        def attempt_once() -> bytes:
            while True:
                sock, from_pool = self.pool.acquire(key, host, port)
                if _sock_cell is not None:
                    _sock_cell["sock"] = sock
                try:
                    send_msg(sock, req)
                    payload = recv_msg(sock)
                except BaseException as e:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    severed = _sock_cell is not None and _sock_cell.get("severed")
                    if from_pool and not severed and isinstance(e, (ConnectionError, OSError)):
                        continue
                    raise
                else:
                    self.pool.release(key, sock)
                    return payload

        return call_with_retries(attempt_once, policy=policy,
                                 retry_on=(ConnectionError, OSError),
                                 describe=f"wire round-trip to {host}:{port}")

    def guard(self, host: str, port: int, cell: dict, what: str | None = None):
        """Watchdog context for one round-trip; disabled for non-finite or
        zero timeouts."""
        timeout = self.pool.timeout
        if not (timeout and np.isfinite(timeout)):
            return nullcontext()
        if self._watchdog is None:
            from ..resilience.watchdog import Watchdog

            self._watchdog = Watchdog(timeout * self._watchdog_factor)

        def sever() -> None:
            # flag before closing: the blocked recv wakes the instant the
            # socket dies, and its error path must already see "severed"
            cell["severed"] = True
            sock = cell.get("sock")
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

        return self._watchdog.guard(what or f"wire round-trip to {host}:{port}",
                                    on_expire=sever)

    def round_trip(self, key, host: str, port: int, *, policy: RetryPolicy,
                   what: str | None = None, **fields) -> dict[str, np.ndarray]:
        """Guarded request and decode in one call."""
        cell: dict = {"sock": None}
        with self.guard(host, port, cell, what=what):
            return unpack_arrays(self.request(key, host, port, policy=policy, _sock_cell=cell,
                                              **fields))

    def evict(self, key) -> None:
        self.pool.evict(key)

    def close(self) -> None:
        self.pool.close()


# -- quarantine clock + replica ordering --------------------------------------


class HealthTable:
    """Quarantine with a doubling re-probe backoff. An entry exists while
    the peer is suspect; each failure pushes the re-probe deadline out by
    the current backoff (jittered by up to ``jitter`` of it, so clients do
    not re-probe a recovering peer in the same instant) and doubles the
    backoff up to the cap; ``lift`` (the peer answered) removes it."""

    def __init__(self, base_s: float, cap_s: float, jitter: float = 0.25):
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.policy = RetryPolicy(attempts=1, base_delay=1.0, factor=1.0, jitter=float(jitter))
        self.lock = threading.Lock()
        self.entries: dict = {}  # guarded-by: lock; key -> {"until", "backoff", "failures"}

    def quarantined(self, key) -> bool:
        with self.lock:
            h = self.entries.get(key)
            return h is not None and time.monotonic() < h["until"]

    def bump(self, key) -> bool:
        """Record one more failure of ``key``; True when this created the
        entry (a fresh peer-down transition)."""
        with self.lock:
            h = self.entries.get(key)
            fresh = h is None
            if fresh:
                h = self.entries[key] = {"until": 0.0, "backoff": self.base_s, "failures": 0}
            h["failures"] += 1
            h["until"] = time.monotonic() + h["backoff"] * self.policy.delay(1)
            h["backoff"] = min(h["backoff"] * 2.0, self.cap_s)
        return fresh

    def lift(self, key) -> dict | None:
        """Remove ``key`` (the peer answered); returns the prior entry."""
        with self.lock:
            return self.entries.pop(key, None)

    def order(self, keys, rot: int = 0) -> list:
        """Healthy peers first, rotated by ``rot``; quarantined peers last,
        soonest re-probe first."""
        keys = list(keys)
        healthy = [k for k in keys if not self.quarantined(k)]
        with self.lock:
            sick = sorted((k for k in keys if k not in healthy and k in self.entries),
                          key=lambda k: self.entries[k]["until"])
        sick += [k for k in keys if k not in healthy and k not in sick]
        if healthy:
            r = rot % len(healthy)
            healthy = healthy[r:] + healthy[:r]
        return healthy + sick

    def due_probes(self) -> list:
        """Keys whose re-probe deadline has passed."""
        now = time.monotonic()
        with self.lock:
            return [k for k, h in self.entries.items() if now >= h["until"]]


__all__ = [
    "HDR",
    "MAGIC",
    "ConnPool",
    "HealthTable",
    "RoundTripper",
    "WireServer",
    "check_pong",
    "copy_sample",
    "encode_samples",
    "error_frame",
    "field_text",
    "frame_detail",
    "pack_arrays",
    "pong_frame",
    "recv_exact",
    "recv_msg",
    "sample_fields",
    "sample_from_arrays",
    "sample_to_arrays",
    "samples_from_frame",
    "send_msg",
    "text_field",
    "token_field",
    "token_ok",
]
