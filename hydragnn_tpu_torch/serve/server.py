"""Always-hot prediction server: persistent process, models resident on the
card, kernels built at warm-up.

Counterpart of ``hydragnn_tpu/serve/server.py`` without its compile cache,
serialized AOT artifacts, fleet, telemetry plane and env flags (later
slices):

- **boot**: register models (architecture + weights + augmented config);
  each endpoint derives its pad-bucket table (the same
  ``compute_pad_buckets`` table training uses) and :meth:`warmup` captures
  the predict step of every bucket as a CUDA graph (``capture.py``, the
  port of the JAX package's AOT executables; the first capture builds the
  CUDA kernels), then replays every graph once under
  ``capture.no_new_captures``, the port of ``no_recompile(0)``. With
  ``Serving.warmup: false`` a bucket is captured at its first batch. On the
  CPU the eager step runs;
- **int8** (``Serving.quantize``): warm-up also calibrates one int8 step per
  bucket on the endpoint's calibration samples (``add_model``'s
  ``samples``), captures it and certifies its per-head error against the
  fp32 answers (``serve.quant``); a bound above ``Serving.quant_tol``
  raises :class:`~hydragnn_tpu_torch.serve.quant.QuantizationError` and
  leaves no int8 graph, and an endpoint with ``quantize`` set never serves
  fp32;
- **steady state**: a bounded request queue with typed load-shedding feeds
  a per-endpoint micro-batcher (``serve.batcher``); each batch is collated
  on the host, copied into its bucket's graph inputs and replayed through
  the shared :class:`~hydragnn_tpu_torch.serve.predictor.Predictor`
  (``answer``), whose outputs are cloned out before the next replay;
- **routing**: several models serve from one process, each endpoint with
  its own queue, bucket table and dispatcher thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np
import torch

from ..capture import no_new_captures
from ..graphs.batching import PadSpec, compute_pad_buckets, is_sorted, pick_bucket
from ..graphs.graph import GraphSample
from ..utils import resolve_device
from .admission import (
    DeadlineExceededError,
    IncompatibleSampleError,
    Request,
    RequestQueue,
    ServerClosedError,
    UnknownModelError,
)
from .batcher import MicroBatcher, serving_collate
from .predictor import Predictor
from .quant import (
    QuantizationError,
    certify_quant_error,
    collect_activation_scales,
    make_quantized_predict_step,
    quantize_dense_weights,
)

# Serving keys of the JAX package's block that the port does not read: a
# config augmented by the JAX package carries them. The in-process server
# ignores ``fleet`` in the JAX package too.
_LATER_SLICE_KEYS = ("fleet",)


def _without_later_keys(block: dict) -> dict:
    return {k: v for k, v in block.items() if k not in _LATER_SLICE_KEYS}


@dataclasses.dataclass
class ServingConfig:
    """The ``Serving`` config block; these field defaults are the schema
    defaults."""

    queue_depth: int = 256     # bounded admission; beyond it requests shed
    flush_ms: float = 5.0      # max micro-batch coalescing latency
    warmup: bool = True        # capture every bucket at boot (else at its first batch)
    max_batch_graphs: int = 0  # per-batch request cap (0 = bucket capacity)
    deadline_ms: float = 0.0   # default per-request deadline (0 = none)
    # int8 inference (serve.quant): calibrate per-(model, bucket) activation
    # scales at warm-up, serve through the int8 kernel, refuse to serve when
    # a head's calibrated error against the fp32 answer exceeds quant_tol
    quantize: bool = False
    quant_tol: float = 0.1         # per-head max abs error ceiling vs fp32
    quant_calib_batches: int = 4   # calibration batches per (model, bucket)

    @staticmethod
    def from_config(config: dict | None) -> "ServingConfig":
        """A full config dict (its ``Serving`` block; absent = defaults) or
        the serving block itself."""
        from ..config.schema import CONFIG_SECTIONS

        config = config or {}
        block = config.get("Serving")
        if block is None and config:
            if any(k in serving_config_defaults() or k in _LATER_SLICE_KEYS for k in config):
                block = config
            elif not any(k in CONFIG_SECTIONS for k in config):
                raise ValueError(
                    f"unrecognized serving config keys {sorted(config)}; expected a full "
                    f"config (sections {sorted(CONFIG_SECTIONS)}) or a Serving block "
                    f"(fields {sorted(serving_config_defaults())})"
                )
        block = _without_later_keys(block or {})
        unknown = set(block) - set(serving_config_defaults())
        if unknown:
            raise ValueError(
                f"Unknown Serving key(s) {sorted(unknown)}; known: "
                f"{sorted(serving_config_defaults())}"
            )
        return ServingConfig(**block)

    def validate(self) -> "ServingConfig":
        if int(self.queue_depth) < 1:
            raise ValueError(f"Serving.queue_depth must be >= 1, got {self.queue_depth}")
        for fkey in ("flush_ms", "deadline_ms"):
            if float(getattr(self, fkey)) < 0:
                raise ValueError(f"Serving.{fkey} must be >= 0, got {getattr(self, fkey)}")
        if int(self.max_batch_graphs) < 0:
            raise ValueError(
                "Serving.max_batch_graphs must be >= 0 (0 = bucket capacity), got "
                f"{self.max_batch_graphs}"
            )
        if float(self.quant_tol) <= 0:
            raise ValueError(f"Serving.quant_tol must be > 0, got {self.quant_tol}")
        if int(self.quant_calib_batches) < 1:
            raise ValueError(
                f"Serving.quant_calib_batches must be >= 1, got {self.quant_calib_batches}"
            )
        if self.quantize and not self.warmup:
            raise ValueError(
                "Serving.quantize requires Serving.warmup: calibration and the error-bound "
                "gate run at warm-up; without it the server would serve fp32 despite "
                "quantize=true"
            )
        return self


def serving_config_defaults() -> dict:
    return dataclasses.asdict(ServingConfig())


def _dummy_sample(example: GraphSample) -> GraphSample:
    """A 1-node, 0-edge sample with ``example``'s feature widths, positional
    encodings (a GPS endpoint's warm-up needs them) and empty triplet
    indices (a DimeNet endpoint's) included."""
    extras = {}
    if "pe" in example.extras:
        k = example.extras["pe"].shape[1]
        extras["pe"] = np.zeros((1, k), np.float32)
        extras["rel_pe"] = np.zeros((0, k), np.float32)
    if "idx_kj" in example.extras:
        extras["idx_kj"] = np.zeros((0,), np.int32)
        extras["idx_ji"] = np.zeros((0,), np.int32)
    return GraphSample(
        x=np.zeros((1, example.x.shape[1]), np.float32),
        edge_attr=np.zeros((0, example.edge_attr.shape[1]), np.float32),
        graph_attr=np.zeros_like(example.graph_attr),
        graph_y=np.zeros_like(example.graph_y),
        node_y=np.zeros((1, example.node_y.shape[1]), np.float32),
        extras=extras,
    )


class ModelEndpoint:
    """One served model: predictor + bucket table + queue + counters."""

    def __init__(self, name: str, predictor: Predictor, buckets: Sequence[PadSpec],
                 example: GraphSample, cfg: ServingConfig, denormalize: bool = False,
                 calib_samples: Sequence[GraphSample] | None = None):
        self.name = name
        self.predictor = predictor
        self.buckets = sorted(buckets, key=lambda p: p.as_tuple())
        self.example = example
        self.cfg = cfg
        self.denormalize = denormalize
        self.warmed = False
        # int8 half (cfg.quantize): one quantized step per bucket, filled by
        # warm_quant only when every head's bound is within quant_tol
        self.calib_samples = list(calib_samples) if calib_samples else [example]
        self.quant_steps: dict[tuple, object] = {}
        self.quant_bounds: list[float] | None = None
        self.thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.counters = {  # guarded-by: _lock
            "submitted": 0, "served": 0, "shed": 0, "shed_deadline": 0,
            "shed_oversize": 0, "failed": 0, "cancelled": 0,
            "batches": 0, "real_graph_slots": 0, "graph_slots": 0,
        }
        self._want_signature = self._signature(example)
        self.reset_queue()

    def reset_queue(self) -> None:
        """Fresh queue + batcher (boot, and re-arm after ``stop()``)."""
        self.queue = RequestQueue(self.cfg.queue_depth)
        self.batcher = MicroBatcher(
            self.queue, self.buckets, flush_s=self.cfg.flush_ms / 1e3,
            max_graphs=self.cfg.max_batch_graphs, on_shed=self._on_shed,
        )

    def _on_shed(self, kind: str) -> None:
        self._count("cancelled" if kind == "cancelled" else f"shed_{kind}")

    def _count(self, key: str, by: int = 1) -> None:
        with self._lock:
            self.counters[key] += by

    @staticmethod
    def _signature(s: GraphSample) -> dict:
        return {
            "x_width": s.x.shape[1],
            "edge_attr_width": s.edge_attr.shape[1],
            "graph_attr_width": s.graph_attr.shape[0],
            "graph_y_width": s.graph_y.shape[0],
            "node_y_width": s.node_y.shape[1],
            # GPS endpoints: collate takes the pe width of a batch's first
            # sample and reads rel_pe wherever pe is present, so a request
            # without them would break its whole micro-batch
            "pe_width": s.extras["pe"].shape[1] if "pe" in s.extras else 0,
            "rel_pe_width": s.extras["rel_pe"].shape[1] if "rel_pe" in s.extras else 0,
            # DimeNet endpoints: a request without triplets would collate
            # (with none) and be answered blind to its angles
            "has_triplets": "idx_kj" in s.extras,
        }

    def check_sample(self, s: GraphSample) -> None:
        """Every request must match the endpoint's feature-width signature."""
        got = self._signature(s)
        want = self._want_signature
        if got != want:
            mismatch = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
            raise IncompatibleSampleError(
                f"sample does not match endpoint {self.name!r}'s signature: "
                f"(got, want) per field: {mismatch}"
            )

    def warm(self) -> dict:
        """Capture every bucket's predict step with a dummy batch (the first
        capture builds the CUDA kernels; the CPU runs the eager step once),
        then, with ``quantize``, the int8 half (:meth:`warm_quant`), then
        :meth:`verify`; returns seconds per bucket."""
        report = {}
        for pad in self.buckets:
            t0 = time.perf_counter()
            self.predictor.answer(self.warm_batch(pad))
            if self.predictor.device.type == "cuda":
                torch.cuda.synchronize(self.predictor.device)
            report[repr(pad)] = time.perf_counter() - t0
        self.warmed = True
        if self.cfg.quantize:
            report["quant"] = self.warm_quant()
        self.verify()
        return report

    def verify(self) -> None:
        """A dummy batch through every bucket's graphs, fp32 and int8, under
        ``capture.no_new_captures``: the JAX warm-up's ``no_recompile(0)``
        pass."""
        with no_new_captures(f"serving warm-up verify [{self.name}]"):
            for pad in self.buckets:
                self.predictor.answer(self.warm_batch(pad))
                step = self.quant_steps.get(pad.as_tuple())
                if step is not None:
                    self.predictor.answer(self.warm_batch(pad), step=step)

    def warm_batch(self, pad: PadSpec):
        """The warm-up's dummy batch of bucket ``pad``, certified as the
        example's batches are: a batch of samples whose ids are ordered as
        the example's certifies the same arrays sorted, so the graph
        captured on the dummy serves them (a one-node dummy would certify
        every array sorted, and traffic would need graphs of its own)."""
        batch = serving_collate([_dummy_sample(self.example)], pad)
        ex = self.example
        return batch.replace(meta=dataclasses.replace(
            batch.meta, recv_sorted=is_sorted(ex.receivers), send_sorted=is_sorted(ex.senders),
            ji_sorted=is_sorted(ex.extras.get("idx_ji", np.zeros(0, np.int32)))))

    def warm_quant(self) -> dict:
        """The int8 half of warm-up (``serve.quant``): per bucket, activation
        scales calibrated on the largest calibration samples the bucket
        admits (collated one per batch, as serving collates them), int8
        weights and the quantized step, and per-head error bounds against
        the fp32 answers on those batches, both through their captured
        graphs on the card (the answers the endpoint serves). A bucket
        without a calibration sample, or a bound above
        ``Serving.quant_tol``, raises :class:`QuantizationError` and leaves
        no int8 step or graph behind. Returns the report (per-bucket layers
        and bounds, the overall bounds)."""
        pred = self.predictor
        for step in self.quant_steps.values():
            pred.dispatches.pop(step, None)
        self.quant_steps = {}
        self.quant_bounds = None
        report: dict = {"buckets": {}}
        bounds = [0.0] * len(pred.cols)
        steps = {}
        k = int(self.cfg.quant_calib_batches)
        for pad in self.buckets:
            fitting = [s for s in self.calib_samples
                       if pick_bucket([pad], s.num_nodes, s.num_edges, 0, 1)]
            if not fitting:
                # certifying on a synthetic dummy would give ~0 bounds that
                # say nothing about real traffic
                self._drop(steps)
                raise QuantizationError(
                    f"endpoint {self.name!r}: no calibration sample fits bucket {pad!r}; "
                    "pass `samples` covering every bucket to add_model (or drop the "
                    "bucket) before enabling Serving.quantize"
                )
            batches = [serving_collate([s], pad)
                       for s in sorted(fitting, key=lambda s: -s.num_nodes)[:k]]
            t0 = time.perf_counter()
            scales = collect_activation_scales(pred.model, batches, pred.compute_dtype)
            weights = quantize_dense_weights(pred.model, scales)
            step = make_quantized_predict_step(pred.model, scales, weights, pred.compute_dtype)
            pad_bounds = certify_quant_error(pred, step, batches)
            bounds = [max(a, b) for a, b in zip(bounds, pad_bounds)]
            steps[pad.as_tuple()] = step
            report["buckets"][repr(pad)] = {
                "seconds": time.perf_counter() - t0,
                "n_dense_layers": len(weights),
                "error_bounds": pad_bounds,
            }
        report["error_bounds"] = bounds
        report["quant_tol"] = self.cfg.quant_tol
        over = [(i, b) for i, b in enumerate(bounds) if b > self.cfg.quant_tol]
        if over:
            self._drop(steps)
            raise QuantizationError(
                f"endpoint {self.name!r}: calibrated int8 error exceeds "
                f"Serving.quant_tol={self.cfg.quant_tol} for head(s) "
                f"{[(i, round(b, 6)) for i, b in over]}; serve fp32 (quantize=false) or "
                "raise quant_tol if the error is acceptable for this model",
                bounds=bounds,
            )
        self.quant_steps = steps
        self.quant_bounds = bounds
        return report

    def _drop(self, steps: dict) -> None:
        """Forget ``steps``' graphs (a refused certification)."""
        for step in steps.values():
            self.predictor.dispatches.pop(step, None)

    def _step_for(self, pad: PadSpec):
        """The bucket's int8 step with ``quantize``, else the fp32 step."""
        if not self.cfg.quantize:
            return None
        step = self.quant_steps.get(pad.as_tuple())
        if step is None:
            raise QuantizationError(
                f"endpoint {self.name!r}: no certified int8 step for bucket {pad!r} "
                "(Serving.quantize never serves fp32)"
            )
        return step

    def serve_batch(self, members: list[Request], pad: PadSpec) -> None:
        # dispatch-time gate: re-check deadlines and claim every future so a
        # client-side cancel can never break the dispatcher
        live = []
        for req in members:
            if req.expired():
                if req.reject(DeadlineExceededError("deadline passed while the batch coalesced")):
                    self._count("shed_deadline")
                else:
                    self._count("cancelled")
            elif req.claim():
                live.append(req)
            else:
                self._count("cancelled")
        members = live
        if not members:
            return
        try:
            batch = serving_collate([r.sample for r in members], pad)
            out = self.predictor.answer(batch, step=self._step_for(pad))
            per_graph = self.predictor.split_graphs(out, [r.sample.num_nodes for r in members])
            if self.denormalize:
                per_graph = [self.predictor.denormalize_preds(heads) for heads in per_graph]
            now = time.monotonic()
            with self._lock:
                seq = self.counters["batches"]
                self.counters["batches"] += 1
                self.counters["real_graph_slots"] += len(members)
                self.counters["graph_slots"] += pad.n_graph - 1
                self.counters["served"] += len(members)
            for slot, (req, heads) in enumerate(zip(members, per_graph)):
                req.future.set_result({
                    "heads": heads,
                    "latency_s": now - req.enqueued_at,
                    "bucket": pad.as_tuple(),
                    "batch_graphs": len(members),
                    "batch": seq,  # the endpoint's batch sequence number
                    "slot": slot,  # position in the batch (collate order)
                })
        except Exception as exc:  # fail this batch's futures, keep serving
            self._count("failed", len(members))
            for req in members:
                if not req.future.done():
                    req.future.set_exception(exc)


class PredictionServer:
    """The persistent multi-model prediction process::

        server = PredictionServer(config)              # device="cuda"
        server.add_model("gin", model, aug_config, samples=train)
        server.warmup()
        server.start()
        fut = server.submit("gin", sample, deadline_ms=50)
        result = fut.result()["heads"]                 # per-head arrays
        server.stop()
    """

    def __init__(self, config: ServingConfig | dict | None = None, device="cuda"):
        self.device = resolve_device(device)
        if isinstance(config, ServingConfig):
            self.cfg = dataclasses.replace(config)
        else:
            self.cfg = ServingConfig.from_config(config)
        self.cfg.validate()
        self._models: dict[str, ModelEndpoint] = {}
        self._running = False
        self._stopping = False

    def add_model(self, name: str, model, config: dict,
                  samples: Sequence[GraphSample] | None = None,
                  buckets: Sequence[PadSpec] | None = None,
                  example: GraphSample | None = None, batch_size: int | None = None,
                  max_buckets: int = 4, denormalize: bool = False) -> ModelEndpoint:
        """Register one model (``config`` is its augmented config). The
        bucket table is ``buckets`` or derived from ``samples``;
        ``example`` (default ``samples[0]``) fixes the feature-width
        signature requests are checked against; with ``Serving.quantize``,
        ``samples`` (default: ``example``) are also the calibration samples
        of the int8 warm-up."""
        if self._running:
            raise RuntimeError("add_model before start(): registration is a boot-time operation")
        if name in self._models:
            raise ValueError(f"model {name!r} already registered")
        if buckets is None:
            if not samples:
                raise ValueError(
                    "add_model needs `samples` to derive the bucket table "
                    "(or pass `buckets` plus an `example` sample)"
                )
            bs = int(batch_size or config["NeuralNetwork"]["Training"].get("batch_size", 32))
            buckets = compute_pad_buckets(samples, bs, max_buckets=max_buckets)
        if example is None and samples:
            example = samples[0]
        if example is None:
            raise ValueError("add_model needs an `example` sample (or `samples`)")
        predictor = Predictor(model, config, device=self.device)
        ep = ModelEndpoint(name, predictor, buckets, example, self.cfg, denormalize=denormalize,
                           calib_samples=samples)
        self._models[name] = ep
        return ep

    def warmup(self) -> dict:
        """Capture every (model, bucket); returns seconds per bucket."""
        t0 = time.perf_counter()
        report = {name: ep.warm() for name, ep in self._models.items()}
        report["total_s"] = time.perf_counter() - t0
        return report

    def start(self) -> "PredictionServer":
        if self._running:
            return self
        if not self._models:
            raise RuntimeError("no models registered")
        if self.cfg.warmup:
            for ep in self._models.values():
                if not ep.warmed:
                    ep.warm()
                elif ep.cfg.quantize and not ep.quant_steps:
                    # the fp32 half is warm but the int8 half is missing (a
                    # caught QuantizationError of an earlier warmup()): run
                    # it again, so start() serves int8 or raises
                    ep.warm_quant()
        self._stopping = False
        for ep in self._models.values():
            if ep.queue.closed:
                ep.reset_queue()
            ep.thread = threading.Thread(
                target=self._dispatch_loop, args=(ep,), name=f"serve-{ep.name}", daemon=True,
            )
            ep.thread.start()
        self._running = True
        return self

    def stop(self) -> None:
        if not self._running:
            return
        self._stopping = True
        for ep in self._models.values():
            for req in ep.queue.close():
                req.reject(ServerClosedError("server stopped with the request queued"))
                ep._count("cancelled")
        for ep in self._models.values():
            if ep.thread is not None:
                ep.thread.join(timeout=10.0)
        self._running = False

    def __enter__(self) -> "PredictionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _dispatch_loop(self, ep: ModelEndpoint) -> None:
        batcher = ep.batcher
        while True:
            got = batcher.next_batch(block=False)
            if got is None:
                if self._stopping or batcher.queue.closed:
                    return
                continue
            ep.serve_batch(*got)

    def submit(self, model: str, sample: GraphSample,
               deadline_ms: float | None = None) -> Future:
        """Admit one request and return its Future; admission failures
        (unknown model, server not started, schema mismatch, queue full)
        raise here, typed."""
        ep = self._models.get(model)
        if ep is None:
            raise UnknownModelError(f"no model {model!r}; serving: {sorted(self._models)}")
        if not self._running:
            raise ServerClosedError("server not started")
        if deadline_ms is None and self.cfg.deadline_ms:
            deadline_ms = self.cfg.deadline_ms
        deadline = time.monotonic() + deadline_ms / 1e3 if deadline_ms else None
        req = Request(sample=sample, deadline=deadline)
        ep._count("submitted")
        try:
            ep.check_sample(sample)
            ep.queue.put(req)
        except Exception:
            ep._count("shed")
            raise
        return req.future

    def predict(self, model: str, samples: Sequence[GraphSample],
                deadline_ms: float | None = None, timeout: float = 60.0):
        """Submit every sample, wait, return the per-request ``heads``."""
        futures = [self.submit(model, s, deadline_ms=deadline_ms) for s in samples]
        return [f.result(timeout=timeout)["heads"] for f in futures]

    def stats(self) -> dict:
        """Per-model counters plus batch occupancy (real graphs per padded
        graph slot), the number of int8 buckets (``quantized``), their
        certified per-head bounds (``quant_bounds``, None without) and the
        CUDA graphs the endpoint captured (``captures``; 0 on the CPU)."""
        out = {}
        for name, ep in self._models.items():
            with ep._lock:
                c = dict(ep.counters)
            c["queue_depth"] = len(ep.queue)
            c["buckets"] = [b.as_tuple() for b in ep.buckets]
            c["warmed"] = ep.warmed
            c["occupancy"] = (
                c["real_graph_slots"] / c["graph_slots"] if c["graph_slots"] else None
            )
            c["quantized"] = len(ep.quant_steps)
            c["quant_bounds"] = ep.quant_bounds
            c["captures"] = ep.predictor.captures()
            out[name] = c
        return out


__all__ = ["ModelEndpoint", "PredictionServer", "ServingConfig", "serving_config_defaults"]
