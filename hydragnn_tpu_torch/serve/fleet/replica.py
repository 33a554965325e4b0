"""One fleet replica: a ``PredictionServer`` behind the wire transport.

Counterpart of ``hydragnn_tpu/serve/fleet/replica.py``. :class:`ReplicaHost`
is the wire front end, a ``utils.wire.WireServer`` with four ops:

* ``predict`` — one graph in (wire sample codec), per-head arrays out;
  typed admission errors (queue full, oversize, deadline, incompatible
  sample, unknown model) travel as ``n=-4`` records carrying the exception
  class name, so the router raises the same ``serve.admission`` types;
* ``ping`` — readiness and identity (model list, per-model quant flags),
  which the router validates through ``wire.check_pong`` before it routes
  to the replica or lifts its quarantine;
* ``stats`` — per-endpoint counters, queue depth, sheds, and
  ``steady_captures``: the CUDA graphs captured since the replica
  advertised ready. A warm replica keeps it at 0, the port's counterpart
  of the JAX replica's steady-lowering count;
* ``metrics`` — ``{"stats", "registry"}``: the stats dict above and the
  replica process's whole telemetry registry (``telemetry.snapshot()``),
  JSON over the wire, which ``FleetRouter.replica_metrics`` decodes.

A predict that arrives with a trace context (``telemetry.propagation``: the
router's ``request_id``) journals one ``replica_execute`` record under that
id; untraced traffic adds no record.

``worker_main`` is the subprocess entry (``python -m
hydragnn_tpu_torch.serve.fleet.replica spec.json``): it boots a
``PredictionServer`` from checkpoint paths alone
(``add_model_from_checkpoint``), on the card unless the spec names
``"device": "cpu"``, opens its own journal (``<log_dir>/events.jsonl``,
default beside the spec, which the ``telemetry fleet`` CLI merges with the
router's), completes the warm-up (every bucket's CUDA graph, and with
``Serving.quantize`` the int8 calibration, certification and graphs), saves
the cost ledger of those captures beside the journal, and only then binds
its port and writes the ready file. ``spawn_replica``
starts one and waits for it. Build the CUDA kernels in the parent before
spawning (``ops._build.build``), so no replica pays for ``nvcc``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ...utils import wire
from ..admission import AdmissionError
from .config import FleetConfig

_PREDICT_TIMEOUT_S = 120.0


class ReplicaBootError(RuntimeError):
    """A worker's ready file existed but could not be trusted (torn or
    foreign contents, or a payload without the boot contract's fields);
    carries the path and the partial contents."""


class ReplicaHost(wire.WireServer):
    """Wire front end of one registered and warmed ``PredictionServer``:
    in-process for tests, or around the checkpoint-booted server of
    ``worker_main``."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 auth_token: str | None = None,
                 predict_timeout_s: float = _PREDICT_TIMEOUT_S, journal=None):
        self.server = server
        self._predict_timeout_s = float(predict_timeout_s)
        # graphs captured at ready: stats() reports the captures since
        self._ready_captures = self._captures()
        super().__init__(host=host, port=port, auth_token=auth_token, name="ReplicaHost",
                         journal=journal)

    def _captures(self) -> int:
        return sum(m["captures"] for m in self.server.stats().values())

    def pong_fields(self) -> dict:
        names = sorted(self.server._models)
        quant = np.asarray([1 if self.server._models[n].cfg.quantize
                            and self.server._models[n].quant_steps else 0 for n in names],
                           np.int64)
        return {"ready": np.asarray(1, np.int64), "models": wire.text_field(",".join(names)),
                "quantized": quant}

    def handle_frame(self, z: dict) -> bytes | dict:
        if "stats" in z:
            return {"n": np.asarray(0, np.int64),
                    "stats": wire.text_field(json.dumps(self.stats()))}
        if "metrics" in z:
            return {"n": np.asarray(0, np.int64),
                    "metrics": wire.text_field(json.dumps(self.metrics()))}
        if "predict" in z:
            return self._handle_predict(z)
        raise ValueError(f"unknown fleet op in frame keys {sorted(z)}")

    def _handle_predict(self, z: dict) -> dict:
        from ... import telemetry as tel

        model = wire.field_text(z.get("model"))
        sample = wire.samples_from_frame(z)[0]
        # the handler thread's scope (the frame's trace context, entered by
        # WireServer) decides whether this predict is journalled
        traced = bool(tel.get_context().get("request_id"))
        try:
            result = self.server.submit(model, sample).result(timeout=self._predict_timeout_s)
        except AdmissionError as e:
            # a shed is an answer about the request: the router raises the
            # same admission class, never a transport fault to fail over
            if traced:
                self.emit_event("replica_execute", model=model, shed=type(e).__name__)
            return {"n": np.asarray(-4, np.int64), "etype": wire.text_field(type(e).__name__),
                    "detail": wire.text_field(str(e)[:512])}
        if traced:
            self.emit_event("replica_execute", model=model,
                            latency_s=round(float(result["latency_s"]), 6))
        out = {"n": np.asarray(1, np.int64), "nheads": np.asarray(len(result["heads"]), np.int64),
               "latency_s": np.asarray(result["latency_s"], np.float64)}
        for i, head in enumerate(result["heads"]):
            out[f"h{i}"] = np.asarray(head)
        return out

    def stats(self) -> dict:
        per_model = self.server.stats()
        return {
            "models": per_model,
            "queue_depth": sum(m["queue_depth"] for m in per_model.values()),
            "shed": sum(m["shed"] for m in per_model.values()),
            "served": sum(m["served"] for m in per_model.values()),
            # CUDA graphs captured since ready: 0 on a warm replica
            "steady_captures": sum(m["captures"] for m in per_model.values())
            - self._ready_captures,
        }

    def metrics(self) -> dict:
        """The ``metrics`` op's payload: :meth:`stats` (first, so the
        ``serve_*`` gauges it publishes are fresh) and the process's whole
        telemetry registry."""
        from ... import telemetry as tel

        stats = self.stats()
        return {"stats": stats, "registry": tel.snapshot()}


# -- subprocess worker --------------------------------------------------------


def _build_server(spec: dict):
    """A ``PredictionServer`` booted from a worker spec: models from
    checkpoint paths alone; the bucket-table (and calibration) samples from
    a wire-codec file beside the spec."""
    from ..server import PredictionServer, ServingConfig

    server = PredictionServer(ServingConfig(**dict(spec.get("serving") or {})),
                              device=spec.get("device", "cuda"))
    for m in spec["models"]:
        with open(m["samples_file"], "rb") as f:
            samples = wire.samples_from_frame(wire.unpack_arrays(f.read()))
        kwargs = {k: m[k] for k in ("batch_size", "max_buckets", "denormalize", "epoch")
                  if k in m}
        server.add_model_from_checkpoint(m["name"], m["log_name"], path=m.get("path", "./logs/"),
                                         samples=samples, **kwargs)
    return server


def worker_main(argv=None) -> int:
    """``python -m hydragnn_tpu_torch.serve.fleet.replica spec.json``.

    Boot order is the readiness contract: build the server, warm it (every
    bucket captured and replayed under ``no_new_captures``, int8 included),
    start it, bind the wire port, write the ready file. A boot failure
    writes ``{"error": ...}`` to the ready file."""
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)

    def _write_ready(payload: dict) -> None:
        ready = spec["ready_file"]
        tmp = ready + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, ready)  # atomic: the parent never reads a torn file

    from ... import telemetry as tel

    try:
        # the worker's own journal and ledger, in its log dir (default:
        # beside the spec)
        log_dir = spec.get("log_dir") or os.path.dirname(
            os.path.abspath(spec.get("ready_file", argv[0])))
        journal = None
        if tel.enabled():
            journal = tel.open_journal(file=os.path.join(log_dir, "events.jsonl"),
                                       run_id=f"replica-{os.getpid()}")
        server = _build_server(spec)
        server.warmup()
        tel.ledger.maybe_save(os.path.join(log_dir, "ledger.json"))
        server.start()
        host = ReplicaHost(server, host=spec.get("bind_host", "127.0.0.1"),
                           port=int(spec.get("port", 0)), auth_token=spec.get("auth"),
                           journal=journal)
    except Exception:
        import traceback

        _write_ready({"error": traceback.format_exc(limit=8)})
        tel.close_journal()
        return 1

    stop = {"flag": False}

    def _terminate(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    _write_ready({"port": host.port, "pid": os.getpid()})
    while not stop["flag"]:
        time.sleep(0.1)
    host.close()
    server.stop()
    tel.close_journal()
    return 0


class ReplicaProcess:
    """Handle on one spawned replica worker."""

    def __init__(self, proc: subprocess.Popen, port: int, spec_path: str, log_path: str):
        self.proc = proc
        self.port = port
        self.spec_path = spec_path
        self.log_path = log_path

    def terminate(self, timeout_s: float = 10.0) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=timeout_s)

    def kill(self) -> None:
        """SIGKILL, no teardown: a host loss."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10.0)

    def log_tail(self, n: int = 40) -> str:
        try:
            with open(self.log_path, errors="replace") as f:
                return "".join(f.readlines()[-n:])
        except OSError:
            return "<no log>"


def write_samples_file(samples, path: str) -> str:
    """Persist bucket-table samples for a worker spec (wire codec)."""
    with open(path, "wb") as f:
        f.write(wire.encode_samples(list(samples)))
    return path


def _read_ready_file(path: str) -> dict:
    """A worker's ready file, or :class:`ReplicaBootError` for anything
    short of the boot contract."""
    try:
        with open(path, errors="replace") as f:
            raw = f.read()
    except OSError as e:
        raise ReplicaBootError(f"ready file {path} unreadable: {e!r}") from e
    try:
        ready = json.loads(raw)
    except ValueError as e:
        raise ReplicaBootError(
            f"ready file {path} is torn or garbage (writer killed mid-write?): {e}; partial "
            f"contents: {raw[:256]!r}") from e
    if not isinstance(ready, dict) or not ("error" in ready or "port" in ready):
        raise ReplicaBootError(
            f"ready file {path} violates the boot contract (expected a dict with 'port' or "
            f"'error'): {raw[:256]!r}")
    return ready


def spawn_replica(spec: dict, timeout_s: float | None = None,
                  env: dict | None = None) -> ReplicaProcess:
    """Start one worker subprocess (``python -m``, never a fork of a process
    that may hold a CUDA context) and block until it advertises ready,
    which means its warm-up finished. Raises with the worker's log tail on
    a boot failure or timeout. ``timeout_s=None`` takes
    ``Serving.fleet.boot_timeout_s`` from the spec's serving block."""
    if timeout_s is None:
        timeout_s = FleetConfig.from_config(
            {"fleet": dict((spec.get("serving") or {}).get("fleet") or {})}).boot_timeout_s
    workdir = tempfile.mkdtemp(prefix="hydragnn-torch-fleet-")
    spec = dict(spec)
    spec.setdefault("ready_file", os.path.join(workdir, "ready.json"))
    spec_path = os.path.join(workdir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    log_path = os.path.join(workdir, "worker.log")
    run_env = dict(os.environ)
    # the worker imports this checkout's package, whatever its cwd
    root = str(Path(__file__).resolve().parents[3])
    run_env["PYTHONPATH"] = os.pathsep.join(p for p in (root, run_env.get("PYTHONPATH")) if p)
    if env:
        run_env.update(env)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "hydragnn_tpu_torch.serve.fleet.replica", spec_path],
            stdout=log, stderr=subprocess.STDOUT, env=run_env)
    handle = ReplicaProcess(proc, port=0, spec_path=spec_path, log_path=log_path)
    deadline = time.monotonic() + float(timeout_s)
    while time.monotonic() < deadline:
        if os.path.exists(spec["ready_file"]):
            try:
                ready = _read_ready_file(spec["ready_file"])
            except ReplicaBootError:
                handle.terminate()
                raise
            if "error" in ready:
                handle.terminate()
                raise RuntimeError(f"replica worker failed to boot:\n{ready['error']}")
            handle.port = int(ready["port"])
            return handle
        if proc.poll() is not None:
            raise RuntimeError(f"replica worker exited rc={proc.returncode} before ready:\n"
                               f"{handle.log_tail()}")
        time.sleep(0.1)
    handle.terminate()
    raise TimeoutError(f"replica worker not ready within {timeout_s}s:\n{handle.log_tail()}")


if __name__ == "__main__":
    sys.exit(worker_main())


__all__ = [
    "ReplicaBootError",
    "ReplicaHost",
    "ReplicaProcess",
    "spawn_replica",
    "worker_main",
    "write_samples_file",
]
