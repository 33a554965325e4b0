#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hydragnn_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Three configurations of ``examples/qm9/qm9.json`` at its published widths
(hidden 64, 4 conv layers, 2 shared layers of 64, graph head [64, 64], mean
pooling, bf16, batch 64, AdamW lr 1e-3), random weights from ``--seed``:
the GIN itself, its GAT variant (``mpnn_type`` GAT: 6 heads, layers 0-2
concatenated to 384 features) and its GPS-GIN variant (GPS multihead
attention, 4 heads, Laplacian positional encodings of width 4).

Phases (any failure exits non-zero; the last line of standard output is the
device JSON only when every phase passed):

1. device: name, count, power limit; TF32 off for matmuls and cuDNN;
2. build: nvcc builds each ``hydragnn_tpu_torch/csrc/*.cu`` from this
   checkout, one process per source, all started together;
3. kernels: each CUDA kernel's wrapper against its plain PyTorch version at
   the main paths' shapes (a collated QM9-like batch at the top pad
   bucket), fp32 and bf16: the gather-scatter sum (scalar and per-channel
   weights, unsorted ids, empty rows) and its transposed launch (the
   backward) over the senders' CSR view; the segment sum; the segment
   softmax over GAT's extended edge layout (6 heads; the dummy row's many
   pieces, unsorted ids, empty segments); the masked row softmax over GPS's
   dense attention blocks (65 graphs, 4 heads, 32 x 32, fully masked rows).
   Device times per call (CUDA-graph replay between CUDA events) beside the
   plain version, a one-call PyTorch yardstick (``torch.sparse.softmax``,
   which synchronises with the host, timed by events around back-to-back
   calls) and the bound;
4. serving, per model: ``PredictionServer`` with 512 concurrent requests;
   served answers against ``Predictor.outputs`` on the same padded batches;
   launch counts per served batch; the card's fp32 answers against the
   port's CPU route on one batch; one ``run_prediction`` pass;
5. training, per model: ``run_training`` in bf16 for a few epochs (the only
   cut of the configuration: ``num_epoch``), with checkpoints in a
   temporary directory; the train loss falls; launch counts per train step;
   one fp32 train step on the card against the CPU route (dropout 0 for
   this check only: the two routes draw other masks); the final checkpoint
   reloaded into a fresh model gives the trained model's
   ``run_prediction``; where a train step's time goes, and the device's busy
   share under ``torch.profiler``;
6. canaries: the tier-1 convergence canaries on the deterministic BCC
   dataset through ``run_training`` and ``run_prediction`` on the card, at
   the reference thresholds: GIN with one head and with four heads (head
   RMSE < 0.25, sample MAE < 0.20), GAT (< 0.60 / < 0.70), GPS-GIN (RMSE of
   the graph head < 0.35).

The script imports only ``hydragnn_tpu_torch``, torch and numpy, and needs no
network.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
QM9_CONFIG = ROOT / "examples" / "qm9" / "qm9.json"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# tolerances of the kernel-vs-plain comparison: fp32 sums differ only in
# the order of additions (the plain version's index_add_ uses atomics on
# the card); bf16 outputs may differ by one bf16 rounding of those sums
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
# the served answers must equal Predictor.outputs on the same padded batch:
# the kernels use no atomics and run in the same order on the same inputs
SERVE_ATOL = 0.0
# the card's fp32 forward against the port's CPU route on the same batch:
# float32 sums in another order across four conv layers and the heads
CPU_PARITY = dict(rtol=1e-4, atol=1e-5)
# one fp32 train step on the card, held tensor by tensor against an fp64 run
# of the same step on the CPU: each parameter's gradient may miss the fp64
# one by at most 8 x the fp32 rounding of that tensor, the larger of what
# the CPU's fp32 route and the card's own step with the plain versions in
# place of the kernels miss it by, or, where both land closer, by 8 x 1e-5
# of the tensor's largest fp64 gradient. Gradients are sums in another
# order through four conv layers, batch norm and the heads, and one that
# nearly cancels carries the rounding of the large terms it cancels: GAT's
# attention gradients sum s * (dy - sum_seg s * dy) over ~20k entries, and
# on the H100 the card's fp32 step misses the fp64 one there by up to 5e-4
# of the tensor's largest gradient with the kernels or without them, the
# CPU's by 1e-6; one draw of such rounding is a loose estimate of its size
# (the card with the kernels misses GAT's layer-2 lin_l.bias gradient by
# 3.6 x what it misses it by with the plain versions). The
# parameters after the first AdamW step, which moves each by
# lr * g / (|g| + 1e-8), agree with the CPU route's to 1e-3 * lr wherever
# |g| exceeds ten times the largest card-vs-CPU gradient difference, and
# elsewhere (gradients at the noise level, which that step follows in sign)
# to 2 * lr, further than one step moves a parameter
STEP_GRAD_TOL = dict(atol_of_max=1e-5, noise_factor=8.0)
# epochs of the full-width training runs: the one cut of qm9.json's config
TRAIN_EPOCHS = 6
# the three configurations of the main paths: qm9.json, its GAT row
# (bench.py ARCH_SWEEP_OVERRIDES "GAT", no override at hidden 64) and the
# GPS knobs of bench.py's gps_gin_dense; max_graph_nodes is derived from
# the data as update_config derives it (32 for molecules of 9-29 atoms)
MODELS = {
    "gin": {},
    "gat": {"mpnn_type": "GAT"},
    "gps": {"global_attn_engine": "GPS", "global_attn_type": "multihead",
            "global_attn_heads": 4, "pe_dim": 4},
}
GAT_HEADS = 6  # the reference GAT stack's fixed head count
# the CSR views a predict step of each model reads (GAT: its extended
# receivers, self loops included), and the one its backward adds
CSR_FORWARD = {"gin": ("receivers", "batch"), "gat": ("loop_receivers", "batch"),
               "gps": ("receivers", "batch")}
CSR_BACKWARD = {"gin": ("senders",), "gat": ("loop_senders",), "gps": ("senders",)}
KERNELS = ("gather_scatter_sum", "gather_scatter_sum_bwd", "segment_sum", "segment_softmax",
           "masked_softmax")
# the tier-1 canaries' GIN (tests/test_config.py CI_CONFIG, with the
# learning rate and epochs of tests/test_training_e2e.py)
CANARY_CONFIG = {
    "Verbosity": {"level": 0},
    "Dataset": {
        "name": "unit_test_singlehead",
        "format": "unit_test",
        "node_features": {"name": ["type", "x", "x2", "x3"], "dim": [1, 1, 1, 1],
                          "column_index": [0, 1, 2, 3]},
        "graph_features": {"name": ["sum"], "dim": [1], "column_index": [0]},
    },
    "NeuralNetwork": {
        "Architecture": {
            "mpnn_type": "GIN", "radius": 2.0, "max_neighbours": 100, "hidden_dim": 8,
            "num_conv_layers": 2,
            "output_heads": {"graph": {"num_sharedlayers": 2, "dim_sharedlayers": 4,
                                       "num_headlayers": 2, "dim_headlayers": [10, 10]}},
            "task_weights": [1.0],
        },
        "Variables_of_interest": {"input_node_features": [0], "output_names": ["sum"],
                                  "output_index": [0], "type": ["graph"],
                                  "denormalize_output": False},
        "Training": {"num_epoch": 100, "perc_train": 0.7, "loss_function_type": "mse",
                     "batch_size": 16, "Optimizer": {"type": "AdamW", "learning_rate": 0.02}},
    },
}
# the canaries and their reference thresholds: (samples, data seed, epochs,
# head RMSE, sample MAE or None, heads held to them). GIN and GAT:
# tests/test_training_e2e.py (GAT at hidden 8); GPS-GIN:
# tests/test_gps.py::test_gps_end_to_end_training (the graph head's RMSE)
CANARIES = {
    "gin_single_head": (500, 7, 100, 0.25, 0.20, None),
    "gin_four_heads": (500, 7, 100, 0.25, 0.20, None),
    "gat": (500, 7, 100, 0.60, 0.70, None),
    "gps_gin": (200, 19, 30, 0.35, None, 1),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def launches_per_forward(kind: str, layers: int) -> dict:
    """Kernel launches of one predict step (a served or evaluated batch)."""
    want = dict.fromkeys(KERNELS, 0)
    want["segment_sum"] = 1  # the mean pooling
    if kind == "gat":
        want["segment_softmax"] = layers
        want["segment_sum"] += layers  # each layer's [E', 6, F] aggregation
    else:
        want["gather_scatter_sum"] = layers
        if kind == "gps":
            want["masked_softmax"] = layers
    return want


def launches_per_train_step(kind: str, layers: int) -> dict:
    """Kernel launches of one train step: the forward's, plus the backward's
    segment sums (GAT: one per softmax and one per gather of node features
    onto the entries) or transposed gather-scatter of each conv layer whose
    input needs a gradient (GIN: not layer 0, which reads the raw features;
    GPS-GIN: every layer, layer 0 reads the learned embedding). The backward
    of a segment sum is a gather, no launch."""
    want = launches_per_forward(kind, layers)
    if kind == "gat":
        # each softmax's backward sum, and the backward of the two gathers
        # (by sender, by receiver) of each layer
        want["segment_sum"] += 3 * layers
    else:
        want["gather_scatter_sum_bwd"] = layers - 1 if kind == "gin" else layers
    return want


def _scaled(counts: dict, k: int) -> dict:
    return {name: n * k for name, n in counts.items()}


def _added(*counts: dict) -> dict:
    return {name: sum(c[name] for c in counts) for name in KERNELS}


def qm9_like_samples(n: int, seed: int, radius: float, max_neighbours: int, pe_dim: int = 0):
    """``n`` QM9-sized molecules: 9-29 atoms uniform in a 6 Å box, ``Z`` in
    1..9 as the one node feature, a random graph target, radius graphs from
    the port's ``radius_graph``; with ``pe_dim``, the Laplacian positional
    encodings a GPS request carries."""
    from hydragnn_tpu_torch.graphs.graph import GraphSample
    from hydragnn_tpu_torch.graphs.radius import radius_graph
    from hydragnn_tpu_torch.preprocess.encodings import attach_lap_pe

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        na = int(rng.integers(9, 30))
        pos = rng.uniform(0.0, 6.0, size=(na, 3))
        z = rng.integers(1, 10, size=(na, 1)).astype(np.float32)
        s, r, sh = radius_graph(pos, radius=radius, max_neighbours=max_neighbours)
        sample = GraphSample(x=z, pos=pos, senders=s, receivers=r, edge_shifts=sh,
                             graph_y=rng.normal(size=(1,)))
        out.append(attach_lap_pe(sample, pe_dim) if pe_dim else sample)
    return out


def qm9_config(kind: str = "gin") -> dict:
    """``examples/qm9/qm9.json`` with the ``kind``'s architecture overrides
    and its dataset replaced by the in-memory QM9-like set (same node and
    graph features)."""
    from hydragnn_tpu_torch.config import load_config

    cfg = load_config(str(QM9_CONFIG))
    cfg["Dataset"] = {
        "name": f"qm9_like_in_memory_{kind}",
        "format": "in_memory",
        "node_features": cfg["Dataset"]["node_features"],
        "graph_features": cfg["Dataset"]["graph_features"],
    }
    cfg["NeuralNetwork"]["Architecture"].update(MODELS[kind])
    return cfg


def prepare(seed: int, kind: str = "gin", n_samples: int = 512):
    """(raw config, augmented config, loaders, samples) of one model."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = qm9_config(kind)
    arch = cfg["NeuralNetwork"]["Architecture"]
    samples = qm9_like_samples(n_samples, seed, float(arch["radius"]),
                               int(arch["max_neighbours"]), int(arch.get("pe_dim") or 0))
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=samples)
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
    return cfg, aug, loaders, samples


# -- phase 1: device -----------------------------------------------------------


def device_phase(torch) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} x{count}; nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return {"kind": name, "count": count, "smi": smi}


# -- phase 2: build ----------------------------------------------------------


def build_phase() -> None:
    from hydragnn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, one nvcc per source, started together")
    for source in _build.SOURCES:
        rec = _build.BUILD_LOG[source]
        log(f"  {source}: {rec['seconds']:.2f} s ({'cached' if rec['cached'] else 'built'}) "
            f"-> {rec['path']}")
        if not rec["cached"]:
            log(f"  nvcc: {rec['command']}")
            for line in rec["ptxas"].splitlines():
                log(f"  ptxas: {line}")


# -- phase 3: kernels against their plain versions ----------------------------


def graph_time_ms(torch, fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph, the graph replayed between CUDA events; the median of ``reps``
    replays divided by ``iters``. No host launch cost is in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def event_time_ms(torch, fn, iters: int = 50, reps: int = 5) -> float:
    """Time of one ``fn()`` call where ``fn`` synchronises with the host and
    so cannot be captured in a CUDA graph: ``iters`` calls back to back
    between CUDA events, the median of ``reps`` windows divided by
    ``iters``. The host's work between launches is in the number."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def bucket_batches(loaders, samples, batch_size: int = 64):
    """Two collated batches of ``batch_size`` training samples: at the top
    pad bucket of the serving table (the path's largest N and E) and, for
    the log, the first training batch that fits the smallest bucket (the
    common case), or None."""
    from hydragnn_tpu_torch.graphs.batching import collate, compute_pad_buckets, pick_bucket

    buckets = compute_pad_buckets(samples, batch_size, max_buckets=4)
    train = loaders[0].samples
    top = collate(train[:batch_size], buckets[-1])
    for k in range(0, len(train) - batch_size + 1, batch_size):
        chunk = train[k : k + batch_size]
        tot = (sum(x.num_nodes for x in chunk), sum(x.num_edges for x in chunk))
        if pick_bucket(buckets, *tot) == buckets[0]:
            return top, collate(chunk, buckets[0])
    return top, None


def _compare(torch, name, got, want, rows, dtype_name) -> float:
    """``got`` against ``want`` on their first ``rows`` rows (an int) or on
    the rows a boolean mask selects."""
    tol = TOL[dtype_name]
    g = (got[:rows] if isinstance(rows, int) else got[rows]).float()
    w = (want[:rows] if isinstance(rows, int) else want[rows]).float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: kernel output not finite")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(torch.allclose(g, w, **tol))
    log(f"  {name}: max|kernel-plain|={err:.3e} (rtol={tol['rtol']}, atol={tol['atol']}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return err


def _bit_stable(torch, name, fn) -> None:
    a, b = fn(), fn()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two launches on the same inputs differ")


def kernel_phase(torch, batch, small=None, n_max: int = 32, timing: bool = True):
    """Every kernel of the serving and training paths against its plain
    version on the card, at ``batch``'s shapes (timed there and, for the
    log, at the ``small`` batch of the smallest bucket); ``n_max`` is GPS's
    dense-attention width. Returns the kernels' JSON entries and their
    device times per call (ms), or ``([], {})`` without ``timing``."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.ops import fused_softmax as fsm

    dev = torch.device("cuda") if timing else torch.device("cpu")
    b = batch.to(dev)
    n, e, g = b.num_nodes, b.num_edges, b.num_graphs
    gen = torch.Generator(device="cpu").manual_seed(1234)
    real_e, real_n = int(b.edge_mask.sum()), int(b.node_mask.sum())
    log(f"kernels at N={n} E={e} G={g} (top pad bucket, collated receivers sorted="
        f"{b.meta.recv_sorted}): {real_e} real edges, {e - real_e} pad edges on row N-1, "
        f"{real_n} real nodes, {n - real_n} pad nodes in the dummy graph")
    recv_idx = b.csr("receivers")
    batch_idx = b.csr("batch")
    mask = b.edge_mask
    real_rows = n - 1  # row N-1 is the reserved dummy row of the pad edges

    def feats(c, dtype):
        return torch.randn(n, c, generator=gen).to(dev, dtype)

    results = {}

    # kernel 1: gather -> scale -> scatter-add over the receiver CSR
    cases = [
        ("fp32 C=64 edge-mask weight", 64, torch.float32, "mask"),
        ("fp32 C=64 per-channel weight", 64, torch.float32, "chan"),
        ("fp32 C=64 no weight", 64, torch.float32, None),
        ("bf16 C=1 edge-mask weight", 1, torch.bfloat16, "mask"),
        ("bf16 C=64 edge-mask weight", 64, torch.bfloat16, "mask"),
    ]
    log("gather_scatter_sum (replaces ops/fused_scatter.py:87 _kernel):")
    errs = []
    for label, c, dtype, wk in cases:
        h = feats(c, dtype)
        if wk == "mask":
            w = mask.to(dtype)
        elif wk == "chan":
            w = (torch.rand(e, c, generator=gen).to(dev) * mask[:, None]).to(dtype)
        else:
            w = None
        got = fs.gather_scatter_sum(h, b.senders, b.receivers, n, weight=w, index=recv_idx)
        want = fs.plain_gather_scatter_sum(h, b.senders, b.receivers, n, w)
        errs.append(_compare(torch, label, got, want, real_rows, str(dtype).split(".")[1]))
    # unsorted ids: the same edges in a random order (the wrapper argsorts)
    perm = torch.randperm(e, generator=gen).to(dev)
    h = feats(64, torch.float32)
    s_u, r_u, w_u = b.senders[perm], b.receivers[perm], mask[perm]
    got = fs.gather_scatter_sum(h, s_u, r_u, n, weight=w_u)
    want = fs.plain_gather_scatter_sum(h, s_u, r_u, n, w_u)
    errs.append(_compare(torch, "fp32 C=64 unsorted receivers", got, want, real_rows,
                         "float32"))
    # empty rows: every fourth node loses its incoming edges
    keep = (b.receivers % 4) != 0
    s_k, r_k, w_k = b.senders[keep], b.receivers[keep], mask[keep]
    got = fs.gather_scatter_sum(h, s_k, r_k, n, weight=w_k)
    want = fs.plain_gather_scatter_sum(h, s_k, r_k, n, w_k)
    errs.append(_compare(torch, "fp32 C=64 empty rows", got, want, real_rows, "float32"))
    if not bool((got[0::4][: real_rows // 4] == 0).all()):
        raise AssertionError("gather_scatter_sum: a row without edges is not 0")
    # long rows: the same edges onto 8 receivers (~2,200 edges, ~70 pieces
    # each), every row compared with an fp64 sum. The kernel's additions
    # nest at most 32 + 9 + 8 deep (piece, strided partials, warp sums), so
    # its fp32 error is below 49 * 2^-24 (3e-6) of the row's sum of |terms|
    # and 1e-5 of it is a safe bound
    r_long = torch.sort(torch.randint(0, 8, (e,), generator=gen).to(dev)).values.int()
    w_l = torch.rand(e, generator=gen).to(dev)
    got = fs.gather_scatter_sum(h, b.senders, r_long, n, weight=w_l)
    terms = h.double()[b.senders.long()] * w_l.double()[:, None]
    ref = torch.zeros(n, 64, dtype=torch.float64, device=dev).index_add_(0, r_long.long(), terms)
    scale = torch.zeros_like(ref).index_add_(0, r_long.long(), terms.abs())
    err = float((got.double() - ref).abs().max())
    ok = bool(((got.double() - ref).abs() <= 1e-5 * scale + 1e-6).all())
    log(f"  fp32 C=64 long rows (8 rows x ~{e // 8} edges) vs fp64: max|err|={err:.3e} "
        f"(bound 1e-5 * sum|terms| + 1e-6) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("gather_scatter_sum: long rows disagree with the fp64 sum")
    results["gather_scatter_sum"] = max(errs)

    # kernel 1's transposed launch (the backward of conv layers 1-3): dout
    # gathered by receiver, scaled by the edge mask, summed onto senders over
    # the senders' CSR view, whose permutation the kernel follows and whose
    # row N-1 owns every pad edge
    send_idx = b.csr("senders")
    log(f"gather_scatter_sum_bwd (replaces the second launch of ops/fused_scatter.py:87 "
        f"_kernel, from _fused_bwd): senders sorted={b.meta.send_sorted}, "
        f"permutation {'yes' if send_idx.perm is not None else 'no'}, "
        f"{int(send_idx.piece_ptr[-1])} pieces")
    dout = feats(64, torch.float32)
    dh = fs.gather_scatter_sum_bwd(dout, b.senders, b.receivers, n, mask, send_idx)
    want = fs.plain_gather_scatter_sum(dout, b.receivers, b.senders, n, mask)
    results["gather_scatter_sum_bwd"] = _compare(
        torch, "fp32 C=64 edge-mask weight, senders' view", dh, want, real_rows, "float32")
    _bit_stable(torch, "gather_scatter_sum_bwd", lambda: fs.gather_scatter_sum_bwd(
        dout, b.senders, b.receivers, n, mask, send_idx))
    log("  two launches on the same inputs: bit-identical")

    # kernel 2: segment sum over the graph CSR (pooling), the node CSR and
    # GAT's extended receivers (its [E', 6 * 64] aggregation)
    log("segment_sum (replaces ops/fused_scatter.py:378 _scatter_kernel):")
    errs = []
    nmask = b.node_mask[:, None]
    for label, c, dtype in (("fp32 [N,64] -> G", 64, torch.float32),
                            ("bf16 [N,64] -> G", 64, torch.bfloat16),
                            ("fp32 [N,1] -> G", 1, torch.float32)):
        x = (feats(c, torch.float32) * nmask).to(dtype)
        got = fs.fused_segment_sum(x, b.batch, g, index=batch_idx)
        want = fs.plain_segment_sum(x, b.batch, g)
        errs.append(_compare(torch, label, got, want, g - 1, str(dtype).split(".")[1]))
    x_e = torch.randn(e, 64, generator=gen).to(dev)
    got = fs.fused_segment_sum(x_e, b.receivers, n, index=recv_idx)
    want = fs.plain_segment_sum(x_e, b.receivers, n)
    errs.append(_compare(torch, "fp32 [E,64] -> N", got, want, real_rows, "float32"))
    ids_u = b.batch[torch.randperm(n, generator=gen).to(dev)]
    x = feats(64, torch.float32)
    got = fs.fused_segment_sum(x, ids_u, g)
    want = fs.plain_segment_sum(x, ids_u, g)
    errs.append(_compare(torch, "fp32 [N,64] -> G unsorted ids", got, want, g - 1,
                         "float32"))
    _, loop_recv = b.self_loop_edges()
    loop_idx = b.csr("loop_receivers")
    e_ext = loop_recv.shape[0]
    msgs = torch.randn(e_ext, GAT_HEADS * 64, generator=gen).to(dev)
    got = fs.fused_segment_sum(msgs, loop_recv, n, index=loop_idx)
    want = fs.plain_segment_sum(msgs, loop_recv, n)
    errs.append(_compare(torch, f"fp32 [E'={e_ext},{GAT_HEADS}x64] -> N (GAT aggregation, "
                         f"self-loop receivers)", got, want, real_rows, "float32"))
    results["segment_sum"] = max(errs)

    # kernel 3: segment softmax over GAT's extended layout: real edges, the
    # alignment slots and the pad edges (logit -1e9, all on the dummy row
    # N-1), then one self loop per node; the receivers are not sorted
    sl_pad = e_ext - e - n
    e_mask = torch.cat([mask, mask.new_zeros(sl_pad), mask.new_ones(n)])
    real_entries = loop_recv != n - 1
    log(f"segment_softmax (replaces ops/fused_softmax.py:116 _softmax_kernel): E'={e_ext} "
        f"entries x {GAT_HEADS} heads ({e} edges, {sl_pad} alignment slots, {n} self loops), "
        f"{int(loop_idx.piece_ptr[-1])} pieces, the dummy row "
        f"{int(loop_idx.ptr[n] - loop_idx.ptr[n - 1])} entries in "
        f"{int(loop_idx.piece_ptr[n] - loop_idx.piece_ptr[n - 1])} pieces")

    def gat_logits(dtype):
        x = torch.randn(e_ext, GAT_HEADS, generator=gen).to(dev) * 3.0
        return torch.where(e_mask[:, None] > 0, x, -1e9).to(dtype)

    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        x = gat_logits(dtype)
        got = fsm.segment_softmax(x, loop_recv, n, index=loop_idx)
        want = fsm.plain_segment_softmax(x, loop_recv, n)
        errs.append(_compare(torch, f"{dname} GAT layout, entries of rows 0..N-2", got, want,
                             real_entries, dname))
        dummy = float((got[~real_entries].float() - want[~real_entries].float()).abs().max())
        log(f"    the dummy row's entries (not gated): max|kernel-plain|={dummy:.3e}")
        _bit_stable(torch, "segment_softmax", lambda: fsm.segment_softmax(
            x, loop_recv, n, index=loop_idx))
    log("  two launches on the same inputs: bit-identical")
    p = torch.randperm(e_ext, generator=gen).to(dev)
    x_u, ids_su = gat_logits(torch.float32)[p], loop_recv[p]
    got = fsm.segment_softmax(x_u, ids_su, n)
    want = fsm.plain_segment_softmax(x_u, ids_su, n)
    errs.append(_compare(torch, "fp32 shuffled entries (the wrapper argsorts)", got, want,
                         ids_su != n - 1, "float32"))
    # empty segments: odd ids fold onto the even ones below them (the dummy
    # row N-1 onto N-2), and segment 10 has only -inf logits (all 0 out)
    ids_e = (loop_recv // 2) * 2
    x_e6 = torch.where((ids_e == 10)[:, None], float("-inf"), gat_logits(torch.float32))
    got = fsm.segment_softmax(x_e6, ids_e, n)
    want = fsm.plain_segment_softmax(x_e6, ids_e, n)
    errs.append(_compare(torch, "fp32 empty odd segments and an all -inf segment", got, want,
                         ids_e < n - 2, "float32"))
    if bool(got[ids_e == 10].any()):
        raise AssertionError("segment_softmax: a segment of -inf logits is not 0")
    results["segment_softmax"] = max(errs)

    # kernel 4: masked row softmax over GPS's dense blocks [G, heads, n, m]
    # with the per-graph validity mask [G, m]; the dummy graph (n_node 0)
    # gives fully masked rows
    valid = torch.arange(n_max, device=dev)[None, :] < b.n_node[:, None]
    log(f"masked_softmax (replaces ops/fused_softmax.py:334 _row_softmax_kernel): "
        f"[G={g}, heads=4, {n_max}, {n_max}], mask [G, {n_max}], "
        f"{int((b.n_node == 0).sum())} fully masked graph(s)")
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        x = (torch.randn(g, 4, n_max, n_max, generator=gen) * 3.0).to(dev, dtype)
        got = fsm.masked_softmax(x, valid)
        want = fsm.plain_masked_softmax(x, valid)
        errs.append(_compare(torch, f"{dname} all rows", got, want, g, dname))
        if bool(got[:-1][(~valid[:-1])[:, None, None, :].expand_as(got[:-1])].any()):
            raise AssertionError("masked_softmax: a masked entry of a real row is not 0")
        if not torch.allclose(got[-1].float(), torch.full_like(got[-1].float(), 1 / n_max),
                              **TOL[dname]):
            raise AssertionError("masked_softmax: fully masked rows are not uniform")
        _bit_stable(torch, "masked_softmax", lambda: fsm.masked_softmax(x, valid))
    log(f"  masked entries of real rows exactly 0; fully masked rows 1/{n_max}; two launches "
        f"on the same inputs bit-identical")
    results["masked_softmax"] = max(errs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if not timing:
        return [], {}
    times = {}

    # times at the path's main shapes: conv layers 1-3 (fp32, C=64) for
    # kernel 1, the mean pooling (fp32 [N,64] -> G) for kernel 2
    h = feats(64, torch.float32)
    w = mask
    k1 = dict(
        ms=graph_time_ms(torch, lambda: fs.gather_scatter_sum(
            h, b.senders, b.receivers, n, weight=w, index=recv_idx)),
        plain_ms=graph_time_ms(torch, lambda: fs.plain_gather_scatter_sum(
            h, b.senders, b.receivers, n, w)),
    )
    # one-call yardstick: the same sum as a CSR sparse product A @ h with
    # A[r, s] = w over the receiver-sorted edges
    a_csr = torch.sparse_csr_tensor(recv_idx.ptr.long(), b.senders.long(), w.float(),
                                    size=(n, n))
    k1["library_ms"] = graph_time_ms(torch, lambda: torch.sparse.mm(a_csr, h))
    lib_err = float((torch.sparse.mm(a_csr, h) - fs.gather_scatter_sum(
        h, b.senders, b.receivers, n, weight=w, index=recv_idx))[:real_rows].abs().max())
    log(f"  yardstick torch.sparse.mm(CSR, h) max|diff| vs kernel = {lib_err:.3e}")
    k1_bytes = (n * 64 * 4) + (2 * e * 4) + (e * 4) + (n * 64 * 4)
    k1_ops = 2 * e * 64
    k1.update(shape=f"h[{n},64] f32, E={e}, w[E]", bytes=k1_bytes, ops=k1_ops)

    pooled_in = (feats(64, torch.float32) * nmask).contiguous()
    ids_long = b.batch.long()
    k2 = dict(
        ms=graph_time_ms(torch, lambda: fs.fused_segment_sum(
            pooled_in, b.batch, g, index=batch_idx)),
        plain_ms=graph_time_ms(torch, lambda: fs.plain_segment_sum(pooled_in, b.batch, g)),
        library_ms=graph_time_ms(torch, lambda: torch.zeros(
            g, 64, device=dev).index_add_(0, ids_long, pooled_in)),
    )
    k2_bytes = (n * 64 * 4) + (n * 4) + (g * 64 * 4)
    k2_ops = n * 64
    k2.update(shape=f"data[{n},64] f32 -> G={g}", bytes=k2_bytes, ops=k2_ops)

    # the transposed launch at conv layers 1-3's backward shapes
    kb = dict(
        ms=graph_time_ms(torch, lambda: fs.gather_scatter_sum_bwd(
            dout, b.senders, b.receivers, n, w, send_idx)),
        plain_ms=graph_time_ms(torch, lambda: fs.plain_gather_scatter_sum(
            dout, b.receivers, b.senders, n, w)),
    )
    # one-call yardsticks: the transposed CSR product A^T @ dout (rows =
    # senders), and index_add_ of the already gathered, scaled messages
    perm_l = send_idx.perm.long()
    at_csr = torch.sparse_csr_tensor(send_idx.ptr.long(), b.receivers.long()[perm_l],
                                     w.float()[perm_l], size=(n, n))
    kb["library_ms"] = graph_time_ms(torch, lambda: torch.sparse.mm(at_csr, dout))
    gathered = dout[b.receivers.long()] * w[:, None]
    send_long = b.senders.long()
    kb["index_add_ms"] = graph_time_ms(torch, lambda: torch.zeros(
        n, 64, device=dev).index_add_(0, send_long, gathered))
    lib_err = float((torch.sparse.mm(at_csr, dout) - dh)[:real_rows].abs().max())
    log(f"  yardstick torch.sparse.mm(transposed CSR, dout) max|diff| vs kernel = {lib_err:.3e}; "
        f"index_add_ of gathered messages {kb['index_add_ms'] * 1e3:.2f} us")
    kb.update(shape=f"dout[{n},64] f32, E={e}, w[E], senders' view", bytes=k1_bytes, ops=k1_ops)

    # kernel 3 at GAT's conv layers 1-3 (fp32 logits [E', 6])
    x_sm = gat_logits(torch.float32)
    loop_long = loop_recv.long()
    # one-call yardstick: torch.sparse.softmax over a COO tensor [N, E', 6]
    # that holds entry e at (receiver, e); unspecified entries count as
    # -inf, so each row's softmax over dim 1 is its segment's softmax. The
    # tensor is built and coalesced once, outside the timed call. The call
    # synchronises with the host (the card refuses it inside a CUDA graph
    # capture), so it is timed by CUDA events around back-to-back calls,
    # and the kernel's wrapper is timed that way beside it
    sp = torch.sparse_coo_tensor(torch.stack([loop_long, torch.arange(e_ext, device=dev)]),
                                 x_sm, (n, e_ext, GAT_HEADS)).coalesce()
    k3 = dict(
        ms=graph_time_ms(torch, lambda: fsm.segment_softmax(x_sm, loop_recv, n, index=loop_idx)),
        plain_ms=graph_time_ms(torch, lambda: fsm.plain_segment_softmax(x_sm, loop_recv, n)),
        # ~32 ms a call on the H100 (the dummy row's ~11.5k entries)
        library_ms=event_time_ms(torch, lambda: torch.sparse.softmax(sp, 1), iters=10, reps=3),
    )
    t_k3_events = event_time_ms(torch, lambda: fsm.segment_softmax(x_sm, loop_recv, n,
                                                                   index=loop_idx),
                                iters=10, reps=3)
    lib = torch.sparse.softmax(sp, 1)
    lib_rows, lib_entries = lib.indices()
    lib_diff = lib.values() - fsm.segment_softmax(x_sm, loop_recv, n, index=loop_idx)[lib_entries]
    log(f"  yardstick torch.sparse.softmax(COO [N, E', {GAT_HEADS}], dim=1) max|diff| vs kernel "
        f"on the entries of rows 0..N-2 = {float(lib_diff[lib_rows != n - 1].abs().max()):.3e}; "
        f"timed by events around back-to-back calls: {k3['library_ms'] * 1e3:.2f} us, the "
        f"kernel's wrapper {t_k3_events * 1e3:.2f} us")
    k3_bytes = 2 * e_ext * GAT_HEADS * 4 + e_ext * 4
    k3_ops = 5 * e_ext * GAT_HEADS  # max, subtract, exp, add, divide per entry
    k3.update(shape=f"logits[{e_ext},{GAT_HEADS}] f32, N={n} segments (GAT self-loop layout)",
              bytes=k3_bytes, ops=k3_ops)
    # the segment sums around it: the [E', 6, 64] aggregation and the
    # softmax backward's [E', 6] sum, both over the same CSR view
    times["segment_sum_gat_agg_ms"] = graph_time_ms(torch, lambda: fs.fused_segment_sum(
        msgs, loop_recv, n, index=loop_idx))
    sdy = torch.randn(e_ext, GAT_HEADS, generator=gen).to(dev)
    times["segment_sum_gat_bwd_ms"] = graph_time_ms(torch, lambda: fs.fused_segment_sum(
        sdy, loop_recv, n, index=loop_idx))
    t_agg_lib = graph_time_ms(torch, lambda: torch.zeros(
        n, GAT_HEADS * 64, device=dev).index_add_(0, loop_long, msgs))
    x_sm16 = gat_logits(torch.bfloat16)
    t_sm16 = graph_time_ms(torch, lambda: fsm.segment_softmax(x_sm16, loop_recv, n,
                                                              index=loop_idx))
    log(f"  segment_sum @ [E'={e_ext},384] f32 -> N (GAT aggregation): kernel "
        f"{times['segment_sum_gat_agg_ms'] * 1e3:.2f} us, index_add_ {t_agg_lib * 1e3:.2f} us; "
        f"@ [E',6] (softmax backward): kernel {times['segment_sum_gat_bwd_ms'] * 1e3:.2f} us; "
        f"segment_softmax bf16 (GAT layer 0): {t_sm16 * 1e3:.2f} us")

    # kernel 4 at GPS's layers 1-3 (fp32 logits [G, 4, n_max, n_max]); the
    # one-call yardstick is torch.softmax of the already masked logits
    x_ms = (torch.randn(g, 4, n_max, n_max, generator=gen) * 3.0).to(dev)
    premasked = torch.where(valid[:, None, None, :], x_ms, -1e9)
    k4 = dict(
        ms=graph_time_ms(torch, lambda: fsm.masked_softmax(x_ms, valid)),
        plain_ms=graph_time_ms(torch, lambda: fsm.plain_masked_softmax(x_ms, valid)),
        library_ms=graph_time_ms(torch, lambda: torch.softmax(premasked, dim=-1)),
    )
    rows = g * 4 * n_max
    k4_bytes = 2 * rows * n_max * 4 + g * n_max
    k4_ops = 5 * rows * n_max
    k4.update(shape=f"logits[{g},4,{n_max},{n_max}] f32, mask[{g},{n_max}]", bytes=k4_bytes,
              ops=k4_ops)
    lib_err = float((torch.softmax(premasked, dim=-1) - fsm.masked_softmax(x_ms, valid))
                    .abs().max())
    x_ms16 = x_ms.to(torch.bfloat16)
    t_ms16 = graph_time_ms(torch, lambda: fsm.masked_softmax(x_ms16, valid))
    log(f"  yardstick torch.softmax(pre-masked logits) max|diff| vs kernel = {lib_err:.3e}; "
        f"masked_softmax bf16 (GPS layer 0): {t_ms16 * 1e3:.2f} us")

    # conv layer 0 of the bf16 predict step: bf16, C = 1
    h0 = feats(1, torch.bfloat16)
    w0 = mask.to(torch.bfloat16)
    t_k = graph_time_ms(torch, lambda: fs.gather_scatter_sum(
        h0, b.senders, b.receivers, n, weight=w0, index=recv_idx))
    t_p = graph_time_ms(torch, lambda: fs.plain_gather_scatter_sum(
        h0, b.senders, b.receivers, n, w0))
    log(f"  gather_scatter_sum @ h[{n},1] bf16 (GIN conv layer 0): kernel {t_k * 1e3:.2f} us, "
        f"plain {t_p * 1e3:.2f} us")
    times["gather_scatter_sum_layer0_ms"] = t_k
    if small is not None:
        s_b = small.to(dev)
        sn, sg = s_b.num_nodes, s_b.num_graphs
        s_h = torch.randn(sn, 64, generator=gen).to(dev)
        s_idx, s_bidx = s_b.csr("receivers"), s_b.csr("batch")
        t_k = graph_time_ms(torch, lambda: fs.gather_scatter_sum(
            s_h, s_b.senders, s_b.receivers, sn, weight=s_b.edge_mask, index=s_idx))
        t_p = graph_time_ms(torch, lambda: fs.plain_gather_scatter_sum(
            s_h, s_b.senders, s_b.receivers, sn, s_b.edge_mask))
        t_k2 = graph_time_ms(torch, lambda: fs.fused_segment_sum(
            s_h, s_b.batch, sg, index=s_bidx))
        t_p2 = graph_time_ms(torch, lambda: fs.plain_segment_sum(s_h, s_b.batch, sg))
        _, s_loop = s_b.self_loop_edges()
        s_lidx = s_b.csr("loop_receivers")
        s_x = torch.randn(s_loop.shape[0], GAT_HEADS, generator=gen).to(dev)
        t_k3 = graph_time_ms(torch, lambda: fsm.segment_softmax(s_x, s_loop, sn, index=s_lidx))
        t_p3 = graph_time_ms(torch, lambda: fsm.plain_segment_softmax(s_x, s_loop, sn))
        log(f"  smallest bucket N={sn} E={s_b.num_edges}: gather_scatter_sum kernel "
            f"{t_k * 1e3:.2f} us / plain {t_p * 1e3:.2f} us; segment_sum kernel "
            f"{t_k2 * 1e3:.2f} us / plain {t_p2 * 1e3:.2f} us; segment_softmax kernel "
            f"{t_k3 * 1e3:.2f} us / plain {t_p3 * 1e3:.2f} us")

    entries = []
    for name, source, src_line, k in (
        ("gather_scatter_sum", "segment_reduce.cu", "hydragnn_tpu/ops/fused_scatter.py:87", k1),
        ("gather_scatter_sum_bwd", "segment_reduce.cu", "hydragnn_tpu/ops/fused_scatter.py:87",
         kb),
        ("segment_sum", "segment_reduce.cu", "hydragnn_tpu/ops/fused_scatter.py:378", k2),
        ("segment_softmax", "segment_softmax.cu", "hydragnn_tpu/ops/fused_softmax.py:116", k3),
        ("masked_softmax", "segment_softmax.cu", "hydragnn_tpu/ops/fused_softmax.py:334", k4),
    ):
        t_bytes = k["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = k["ops"] / FP32_FLOPS * 1e3
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"hydragnn_tpu_torch/csrc/{source}",
            "replaces": src_line,
            "launches": 0,
            "max_abs_err": results[name],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": k["library_ms"],
            "shape": k["shape"],
        })
        if "index_add_ms" in k:
            entries[-1]["index_add_ms"] = k["index_add_ms"]
        log(f"  {name} @ {k['shape']}: kernel {k['ms'] * 1e3:.2f} us, plain "
            f"{k['plain_ms'] * 1e3:.2f} us, one-call yardstick {k['library_ms'] * 1e3:.2f} us, "
            f"bound {max(t_bytes, t_ops) * 1e3:.3f} us ({k['bytes']} B at 3.35 TB/s)")
    for e_ in entries:
        times[e_["name"] + "_ms"] = e_["ms"]
    return entries, times


def step_kernel_ms(kind: str, layers: int, kt: dict) -> float:
    """Device time of one train step's kernel launches from the kernel
    phase's times (fp32 shapes; GIN's conv layer 0 at its bf16 C = 1)."""
    per = launches_per_train_step(kind, layers)
    if kind == "gat":
        # aggregation and the two gathers' backward sums at [E', 6 * 64]
        return (per["segment_softmax"] * kt.get("segment_softmax_ms", 0.0)
                + 3 * layers * kt.get("segment_sum_gat_agg_ms", 0.0)
                + layers * kt.get("segment_sum_gat_bwd_ms", 0.0)
                + kt.get("segment_sum_ms", 0.0))
    gs = (kt.get("gather_scatter_sum_layer0_ms", 0.0) + (layers - 1) *
          kt.get("gather_scatter_sum_ms", 0.0)) if kind == "gin" else \
        layers * kt.get("gather_scatter_sum_ms", 0.0)
    return (gs + per["gather_scatter_sum_bwd"] * kt.get("gather_scatter_sum_bwd_ms", 0.0)
            + kt.get("segment_sum_ms", 0.0)
            + per["masked_softmax"] * kt.get("masked_softmax_ms", 0.0))


# -- phase 4: serving --------------------------------------------------------


def serving_phase(torch, device: str, seed: int, kind: str = "gin", n_clients: int = 4,
                  card: str = "") -> dict:
    """One model behind ``PredictionServer``: warm-up, concurrent requests,
    served answers against ``Predictor.outputs``, launch counts."""
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.serve import PredictionServer, Predictor, ServingConfig
    from hydragnn_tpu_torch.serve.batcher import serving_collate

    cfg, aug, loaders, samples = prepare(seed, kind)
    spec_arch = aug["NeuralNetwork"]["Architecture"]
    n_layers = int(spec_arch["num_conv_layers"])
    model = create_model_config(aug, device=device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    extra = {k: spec_arch.get(k) for k in MODELS[kind]}
    if kind == "gps":
        extra["max_graph_nodes"] = spec_arch["max_graph_nodes"]
    log(f"[{kind}] model: {spec_arch['mpnn_type']} hidden {spec_arch['hidden_dim']} x "
        f"{n_layers} conv layers {extra or ''}, {n_params} parameters, precision "
        f"{aug['NeuralNetwork']['Training']['precision']}, seed {seed}")

    name = f"qm9_{kind}"
    server = PredictionServer(ServingConfig(queue_depth=2048, flush_ms=5.0), device=device)
    ep = server.add_model(name, model, aug, samples=samples)
    log(f"[{kind}] buckets (n_node, n_edge, n_graph, n_triplet): "
        f"{[b.as_tuple() for b in ep.buckets]}")
    t0 = time.perf_counter()
    server.warmup()
    log(f"[{kind}] warm-up: {time.perf_counter() - t0:.3f} s over {len(ep.buckets)} buckets")
    server.start()
    results: list = [None] * len(samples)
    try:
        fs.reset_launches()
        t_start = time.perf_counter()

        def client(k):
            futs = [(i, server.submit(name, samples[i]))
                    for i in range(k, len(samples), n_clients)]
            for i, f in futs:
                results[i] = f.result(timeout=300)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("serving: client threads did not finish")
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = dict(fs.LAUNCHES)
        stats = server.stats()[name]
    finally:
        server.stop()

    if any(r is None for r in results):
        raise AssertionError("serving: some requests got no answer")
    n_batches = stats["batches"]
    log(f"[{kind}] served {stats['served']} requests in {n_batches} batches, failed "
        f"{stats['failed']}, shed {stats['shed']}, occupancy {stats['occupancy']:.3f}")
    if stats["served"] != len(samples) or stats["failed"]:
        raise AssertionError(f"serving: {stats}")
    for r in results:
        if not all(np.isfinite(np.asarray(h)).all() for h in r["heads"]):
            raise AssertionError("serving: non-finite answer")
    per_batch = launches_per_forward(kind, n_layers)
    want = _scaled(per_batch, n_batches)
    log(f"[{kind}] launches during serving: {launches} (expected {want}: "
        f"{ {k: v for k, v in per_batch.items() if v} } per batch, no backward)")
    if device == "cuda" and launches != want:
        raise AssertionError(f"serving: launch counts {launches} != {want}")

    # served answers == Predictor.outputs on the same padded batch
    by_batch: dict = {}
    for i, r in enumerate(results):
        by_batch.setdefault(r["batch"], []).append((r["slot"], i, r))
    predictor = Predictor(model, aug, device=device)
    worst = 0.0
    for members in by_batch.values():
        members.sort(key=lambda m: m[0])
        pad = next(b for b in ep.buckets if b.as_tuple() == tuple(members[0][2]["bucket"]))
        chunk = [samples[i] for _, i, _ in members]
        out = predictor.outputs(serving_collate(chunk, pad))
        per_graph = predictor.split_graphs(out, [s.num_nodes for s in chunk])
        for (_, _, r), heads in zip(members, per_graph):
            for a, b in zip(r["heads"], heads):
                worst = max(worst, float(np.max(np.abs(np.asarray(a) - np.asarray(b)))))
    log(f"[{kind}] served vs Predictor.outputs on the same padded batches: "
        f"max|diff|={worst:.3e} (allowed {SERVE_ATOL})")
    if worst > SERVE_ATOL:
        raise AssertionError("serving: served answers differ from Predictor.outputs")

    lat = np.array([r["latency_s"] for r in results]) * 1e3
    graphs_per_s = len(samples) / wall
    log(f"[{card}] [{kind}] serving: {len(samples)} requests from {n_clients} client threads, "
        f"{n_batches} batches, p50 {np.percentile(lat, 50):.2f} ms, p99 "
        f"{np.percentile(lat, 99):.2f} ms, {graphs_per_s:.1f} graphs/s (wall {wall:.3f} s)")

    # the card against the port's CPU route (fp32 both), one batch
    fp32_cfg = copy.deepcopy(aug)
    fp32_cfg["NeuralNetwork"]["Training"]["precision"] = "fp32"
    test_batch = next(iter(loaders[2]))
    dev_out = Predictor(model, fp32_cfg, device=device).outputs(test_batch)
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_out = Predictor(cpu_model, fp32_cfg, device="cpu").outputs(test_batch)
    gm = test_batch.graph_mask > 0
    d = float((dev_out[0].cpu()[gm] - cpu_out[0][gm]).abs().max())
    ok = torch.allclose(dev_out[0].cpu()[gm], cpu_out[0][gm], **CPU_PARITY)
    log(f"[{kind}] {device} fp32 forward vs the CPU route on one test batch: max|diff|={d:.3e} "
        f"(rtol={CPU_PARITY['rtol']}, atol={CPU_PARITY['atol']}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("the card's forward disagrees with the CPU route")

    # where a served batch's time goes (top bucket, as served: bf16 step;
    # each predict step gets a fresh device batch, so it builds the batch's
    # CSR views as a served batch does)
    chunk = loaders[0].samples[:64]
    pad = ep.buckets[-1]
    host_batch = serving_collate(chunk, pad)
    reps = 20
    fresh = iter([host_batch.to(device) for _ in range(reps)])
    fresh_csr = iter([host_batch.to(device) for _ in range(reps)])

    def wall_ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            if device == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    t_collate = wall_ms(lambda: serving_collate(chunk, pad))
    t_h2d = wall_ms(lambda: host_batch.to(device))
    t_fwd = wall_ms(lambda: predictor.outputs(next(fresh)))

    def build_csr():
        b = next(fresh_csr)
        for field in CSR_FORWARD[kind]:
            b.csr(field)

    t_csr = wall_ms(build_csr)
    out = predictor.outputs(host_batch)
    t_split = wall_ms(lambda: predictor.split_graphs(out, [s.num_nodes for s in chunk]))
    log(f"[{card}] [{kind}] one served batch at the top bucket (median of 20, host clock): "
        f"collate {t_collate:.3f} ms, to device {t_h2d:.3f} ms, predict step {t_fwd:.3f} ms "
        f"(of which building the CSR views {'+'.join(CSR_FORWARD[kind])} {t_csr:.3f} ms), "
        f"split to numpy {t_split:.3f} ms")

    # the batch evaluator over the same samples
    fs.reset_launches()
    t0 = time.perf_counter()
    error, _, trues, preds = run_prediction(copy.deepcopy(cfg), model, samples=samples,
                                            device=device)
    rp_s = time.perf_counter() - t0
    rp_launches = dict(fs.LAUNCHES)
    n_rp = len(loaders[2])
    log(f"[{kind}] run_prediction: {preds[0].shape[0]} test graphs in {n_rp} batches, mse "
        f"{error:.6f}, {rp_s:.3f} s, launches {rp_launches}")
    if not np.isfinite(error) or preds[0].shape != trues[0].shape:
        raise AssertionError("run_prediction: bad result")
    if device == "cuda" and rp_launches != _scaled(per_batch, n_rp):
        raise AssertionError(f"run_prediction: launch counts {rp_launches}")
    return {"launches": launches, "batches": n_batches}


# -- phase 5: training -----------------------------------------------------------


def _sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def _plain_versions_on_card():
    """Inside, the ops' wrappers take their plain PyTorch versions for CUDA
    tensors too: the fp32 step check's measure of the card's own rounding
    without the kernels. The port itself routes by device only."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.ops import fused_softmax as fsm

    saved = fs._route, fsm._route
    fs._route = fsm._route = lambda name, t: False
    try:
        yield
    finally:
        fs._route, fsm._route = saved


def _step_vs_cpu(torch, aug: dict, host_batch, device: str, seed: int) -> None:
    """One fp32 train step from the same parameters on the same batch, on
    ``device`` and on the port's CPU route, each held against an fp64 run of
    the step on the CPU: gradients, then updated parameters and running
    statistics against the CPU route's. Dropout is 0 here: the card's
    generator and the CPU's draw different masks from the same seed."""
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.step import create_train_state, make_train_step

    aug = copy.deepcopy(aug)
    aug["NeuralNetwork"]["Architecture"]["dropout"] = 0.0
    opt_cfg = aug["NeuralNetwork"]["Training"]["Optimizer"]
    lr = float(opt_cfg["learning_rate"])
    card = create_model_config(aug, device=device, seed=seed)
    plain = copy.deepcopy(card)
    host = copy.deepcopy(card).to("cpu")
    ref = copy.deepcopy(host).double()
    s_card, s_host = create_train_state(card, opt_cfg), create_train_state(host, opt_cfg)
    step = make_train_step(torch.float32)
    step(s_card, host_batch.to(device))
    step(s_host, host_batch)
    # the same step on the card with every kernel replaced by its plain
    # version: the rounding of the card's other operations (matrix
    # products, reductions) on each tensor, which the kernels must not
    # make worse
    if device == "cuda":
        with _plain_versions_on_card():
            step(create_train_state(plain, opt_cfg), host_batch.to(device))
    # an fp64 run of the same step (the plain versions sum fp64 input in
    # fp64)
    make_train_step(torch.float64)(create_train_state(ref, opt_cfg),
                                   host_batch.map_floats(lambda t: t.double()))
    _sync(torch, device)
    grads = {n: (p.grad.cpu(), dict(host.named_parameters())[n].grad)
             for n, p in card.named_parameters()}
    plain_grads = {n: p.grad for n, p in plain.named_parameters()}
    ref_grads = {n: p.grad for n, p in ref.named_parameters()}
    worst = (-1.0, "", 0.0, 0.0, 0.0, 0.0)  # (error / bound, name, card, cpu, plain, bound)
    # card, cpu and plain errors over the tensor's largest gradient (at
    # least 1e-3 of the model's: a gradient that is 0 in exact arithmetic
    # is all rounding)
    loosest = (-1.0, "", 0.0, 0.0)
    model_max = max(float(g.abs().max()) for g in ref_grads.values())
    for name, (c, h) in grads.items():
        r64 = ref_grads[name]
        g_max = float(r64.abs().max())
        card_err = float((c.double() - r64).abs().max())
        cpu_err = float((h.double() - r64).abs().max())
        plain_err = (float((plain_grads[name].cpu().double() - r64).abs().max())
                     if device == "cuda" else 0.0)
        bound = STEP_GRAD_TOL["noise_factor"] * max(
            cpu_err, plain_err, STEP_GRAD_TOL["atol_of_max"] * g_max)
        if card_err > bound:
            raise AssertionError(
                f"fp32 train step: the {device} gradient of {name} misses the fp64 step by "
                f"{card_err:.3e}; the CPU route's by {cpu_err:.3e}, the {device}'s plain "
                f"versions' by {plain_err:.3e} (allowed {bound:.3e})")
        ratio = card_err / bound if bound > 0 else 0.0
        if ratio > worst[0]:
            worst = (ratio, name, card_err, cpu_err, plain_err, bound)
        scale = max(g_max, 1e-3 * model_max)
        if card_err / scale > loosest[0]:
            loosest = (card_err / scale, name, cpu_err / scale, plain_err / scale)
    worst_g = max(float((c - h).abs().max()) for c, h in grads.values())
    floor = 10 * worst_g
    worst_p = worst_noise = 0.0
    n_noise = 0
    for (name, p), q in zip(card.named_parameters(), host.parameters()):
        g = grads[name][1]
        diff = (p.detach().cpu() - q.detach()).abs()
        noise = g.abs() <= floor
        n_noise += int(noise.sum())
        worst_p = max(worst_p, float(diff[~noise].max()) if bool((~noise).any()) else 0.0)
        worst_noise = max(worst_noise, float(diff[noise].max()) if bool(noise.any()) else 0.0)
    for (name, a), b in zip(card.named_buffers(), host.buffers()):
        if not torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"fp32 train step: running statistic {name} differs")
    log(f"fp32 train step (dropout 0), {device} vs the CPU route: max|grad diff| {worst_g:.3e}; "
        f"per tensor against an fp64 step, {device}'s error within "
        f"{STEP_GRAD_TOL['noise_factor']} x the largest of the CPU route's, the {device}'s with "
        f"the plain versions in place of the kernels and {STEP_GRAD_TOL['atol_of_max']} x the "
        f"tensor's largest gradient; closest to its bound {worst[1]}: {device} {worst[2]:.3e}, "
        f"CPU {worst[3]:.3e}, plain versions {worst[4]:.3e}, bound {worst[5]:.3e} "
        f"({100 * worst[0]:.1f}% of it); largest error relative to its tensor's largest "
        f"gradient (at least 1e-3 of the model's) {loosest[1]}: {device} {loosest[0]:.2e}, CPU "
        f"{loosest[2]:.2e}, plain versions "
        f"{loosest[3]:.2e}; parameters after AdamW max|diff| {worst_p:.3e} (allowed "
        f"{1e-3 * lr:.1e} = 1e-3 lr) and {worst_noise:.3e} on {n_noise} noise-level gradients "
        f"(allowed {2 * lr:.1e} = 2 lr)")
    if worst_p > 1e-3 * lr or worst_noise > 2 * lr:
        raise AssertionError("fp32 train step: updated parameters differ from the CPU route")


def training_phase(torch, device: str, seed: int, kind: str = "gin",
                   kernel_times: dict | None = None, card: str = "",
                   epochs: int = TRAIN_EPOCHS) -> dict:
    """``run_training`` on one qm9.json model (bf16, its published widths;
    ``num_epoch`` cut to ``epochs``): falling train loss, launch counts,
    checkpoint reload, the fp32 step against the CPU route, and where a
    train step's time goes."""
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.config import get_log_name_config
    from hydragnn_tpu_torch.graphs.batching import collate
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
    from hydragnn_tpu_torch.train.checkpoint import load_checkpoint
    from hydragnn_tpu_torch.train.step import cast_forward, create_train_state, make_train_step

    cfg = qm9_config(kind)
    published = cfg["NeuralNetwork"]["Training"]["num_epoch"]
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = epochs
    arch = cfg["NeuralNetwork"]["Architecture"]
    n_layers = int(arch["num_conv_layers"])

    def samples():
        # no encodings attached here: run_training's preprocessing attaches
        # GPS's, as it does for its users' samples
        return qm9_like_samples(512, seed, float(arch["radius"]), int(arch["max_neighbours"]))

    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=samples())
    n_train, n_val, n_test = (len(ld) for ld in loaders)
    log(f"[{kind}] training: run_training on the qm9.json {arch['mpnn_type']}"
        f"{' + GPS' if kind == 'gps' else ''} at its published widths, precision "
        f"{cfg['NeuralNetwork']['Training']['precision']}, dropout "
        f"{arch.get('dropout', 0.25)} (default), num_epoch cut from {published} to {epochs} "
        f"(the only cut), 512 QM9-like molecules: {n_train} train / {n_val} val / {n_test} "
        f"test batches per epoch, seed {seed}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        history: list = []
        fs.reset_launches()
        t0 = time.perf_counter()
        state, model, aug = run_training(copy.deepcopy(cfg), samples=samples(),
                                         device=device, path=tmp, seed=seed, history=history)
        _sync(torch, device)
        wall = time.perf_counter() - t0
        launches = dict(fs.LAUNCHES)
        losses = [h["train_loss"] for h in history]
        log(f"[{card}] [{kind}] run_training: {len(history)} epochs, {state.step} train steps "
            f"in {wall:.3f} s (epochs {[round(h['seconds'], 3) for h in history]} s, each with "
            f"its evaluations and checkpoint; the rest is set-up and the final save); train "
            f"loss per epoch {[round(x, 6) for x in losses]}; val loss "
            f"{[round(h['val_loss'], 6) for h in history]}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"training: the train loss did not fall: {losses}")
        steps, evals = state.step, len(history) * (n_val + n_test)
        per_step = launches_per_train_step(kind, n_layers)
        per_eval = launches_per_forward(kind, n_layers)
        want = _added(_scaled(per_step, steps), _scaled(per_eval, evals))
        log(f"[{kind}] launches during run_training: {launches} (expected {want}: per train "
            f"step { {k: v for k, v in per_step.items() if v} }, per eval batch "
            f"{ {k: v for k, v in per_eval.items() if v} })")
        if device == "cuda" and launches != want:
            raise AssertionError(f"training: launch counts {launches} != {want}")

        # the final checkpoint, reloaded into a fresh model (other random
        # weights), gives the trained model's run_prediction
        fresh = create_model_config(aug, device=device, seed=seed + 1)
        meta = load_checkpoint(create_train_state(fresh, aug["NeuralNetwork"]["Training"]
                                                  ["Optimizer"]),
                               get_log_name_config(aug), path=tmp)
        ref = run_prediction(copy.deepcopy(cfg), state, samples=samples(), device=device)
        got = run_prediction(copy.deepcopy(cfg), fresh, samples=samples(), device=device)
        diff = max(float(np.max(np.abs(a - b))) for a, b in zip(ref[3], got[3]))
        log(f"[{kind}] checkpoint {meta}: reloaded model's run_prediction vs the trained "
            f"model's: mse {got[0]:.6f} vs {ref[0]:.6f}, max|diff| {diff:.3e} (allowed 0)")
        if diff != 0.0 or got[0] != ref[0]:
            raise AssertionError("training: the reloaded checkpoint predicts differently")

    # one train step at the top bucket, alone: its launches
    train_ld = loaders[0]
    chunk = train_ld.samples[:64]
    host = collate(chunk, train_ld.pad)
    step = make_train_step(torch.bfloat16)
    fs.reset_launches()
    step(state, host.to(device))
    _sync(torch, device)
    one_step = dict(fs.LAUNCHES)
    log(f"[{kind}] launches of one train step: {one_step} (expected {per_step})")
    if device == "cuda" and one_step != per_step:
        raise AssertionError(f"training: one step launched {one_step} != {per_step}")

    _step_vs_cpu(torch, aug, host, device, seed)

    # where a bf16 train step's time goes (top bucket, median of 20, host
    # clock after a synchronise; each step on a fresh device batch, so it
    # builds the batch's CSR views as a training step does)
    reps = 20
    fresh_batches = [host.to(device) for _ in range(reps)]
    optimizer = state.optimizer
    parts: dict = {k: [] for k in ("collate", "to_device", "csr_forward", "csr_backward",
                                   "forward", "backward", "optimizer", "step")}

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        _sync(torch, device)
        parts[key].append((time.perf_counter() - t) * 1e3)
        return out

    for b in fresh_batches:
        timed("collate", lambda: collate(chunk, train_ld.pad))
        timed("to_device", lambda: host.to(device))
        timed("csr_forward", lambda: [b.csr(f) for f in CSR_FORWARD[kind]])
        timed("csr_backward", lambda: [b.csr(f) for f in CSR_BACKWARD[kind]])
        tot = timed("forward", lambda: model.loss(
            cast_forward(model, b, torch.bfloat16, train=True, generator=state.generator),
            b)[0])
        timed("backward", lambda: (optimizer.zero_grad(), tot.backward()))
        timed("optimizer", optimizer.step)
    for b in [host.to(device) for _ in range(reps)]:
        timed("step", lambda: step(state, b))
    med = {k: float(np.median(v)) for k, v in parts.items()}
    kernel_ms = step_kernel_ms(kind, n_layers, kernel_times or {})
    log(f"[{card}] [{kind}] one bf16 train step at the top bucket (median of {reps}, host "
        f"clock): collate {med['collate']:.3f} ms, to device {med['to_device']:.3f} ms, CSR "
        f"views {'+'.join(CSR_FORWARD[kind])} {med['csr_forward']:.3f} ms, backward CSR views "
        f"{'+'.join(CSR_BACKWARD[kind]) or '(none)'} {med['csr_backward']:.3f} ms, forward "
        f"{med['forward']:.3f} ms, backward {med['backward']:.3f} ms, optimizer "
        f"{med['optimizer']:.3f} ms; whole train step {med['step']:.3f} ms, of which kernels "
        f"~{kernel_ms * 1e3:.2f} us of device time ({100 * kernel_ms / med['step']:.2f}%)")
    if device == "cuda":
        _profile_steps(torch, step, state, host, device, f"[{card}] [{kind}]")
    return {"launches": launches, "per_step": one_step, "breakdown": med, "layers": n_layers}


def _profile_steps(torch, step, state, host, device: str, tag: str, n_steps: int = 10) -> None:
    """The device's busy share of ``n_steps`` bf16 train steps under
    ``torch.profiler``: the summed time of the device kernels and copies
    over the window's host-clock wall (the tracing slows the host, so the
    share is a lower bound), and device operations per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [host.to(device) for _ in range(n_steps)]
    step(state, batches[0])
    _sync(torch, device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            step(state, b)
        _sync(torch, device)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log(f"{tag} profiler: no device events traced; busy share not measured")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    steps = n_steps - 1
    log(f"{tag} profiler over {steps} bf16 train steps: device busy {busy_us / steps:.1f} us "
        f"per step of {wall_us / steps / 1e3:.3f} ms wall ({100 * busy_us / wall_us:.2f}% busy, "
        f"{100 - 100 * busy_us / wall_us:.2f}% idle), {len(dev) / steps:.0f} device operations "
        f"per step")


# -- phase 6: the convergence canaries ------------------------------------------


def canary_config(name: str, epochs: int | None = None) -> dict:
    """``CANARY_CONFIG`` for one canary: the GIN with one graph head, or
    the 4-head variant of ``tests/test_training_e2e.py`` (graph sum + nodal
    x, x2, x3; graph head weighted 20x; node heads 2 x 10; batch 16; lr
    0.01); GAT at hidden 8; GPS-GIN with 2 heads and encodings of width 2
    (``tests/test_gps.py``)."""
    cfg = copy.deepcopy(CANARY_CONFIG)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = epochs or CANARIES[name][2]
    arch = cfg["NeuralNetwork"]["Architecture"]
    if name == "gin_four_heads":
        cfg["NeuralNetwork"]["Variables_of_interest"] = {
            "input_node_features": [0], "output_names": ["sum", "x", "x2", "x3"],
            "output_index": [0, 1, 2, 3], "type": ["graph", "node", "node", "node"],
            "denormalize_output": False,
        }
        arch["task_weights"] = [20.0, 1.0, 1.0, 1.0]
        arch["output_heads"]["graph"]["dim_sharedlayers"] = 10
        arch["output_heads"]["node"] = {"num_headlayers": 2, "dim_headlayers": [10, 10],
                                        "type": "mlp"}
        cfg["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"] = 0.01
    elif name == "gat":
        arch.update(mpnn_type="GAT", hidden_dim=8)
    elif name == "gps_gin":
        arch.update(global_attn_engine="GPS", global_attn_heads=2, pe_dim=2)
    return cfg


def _model_kind(cfg: dict) -> str:
    """The key of ``MODELS`` whose launch counts a config's model follows."""
    arch = cfg["NeuralNetwork"]["Architecture"]
    if arch.get("global_attn_engine"):
        return "gps"
    return "gat" if arch["mpnn_type"] == "GAT" else "gin"


def canary_phase(torch, device: str, card: str = "", epochs: int | None = None,
                 n_samples: int | None = None, check: bool = True,
                 names=tuple(CANARIES)) -> dict:
    """The canaries through run_training and run_prediction on the BCC
    data, every held head below the reference thresholds."""
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.datasets import deterministic_graph_data
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    out = {}
    for name in names:
        n_default, data_seed, _, rmse_max, mae_max, held = CANARIES[name]
        n = n_samples or n_default
        cfg = canary_config(name, epochs)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            fs.reset_launches()
            t0 = time.perf_counter()
            state, _, _ = run_training(copy.deepcopy(cfg), device=device, path=tmp,
                                       samples=deterministic_graph_data(n, seed=data_seed))
            _, _, trues, preds = run_prediction(
                copy.deepcopy(cfg), state, device=device,
                samples=deterministic_graph_data(n, seed=data_seed))
            _sync(torch, device)
            wall = time.perf_counter() - t0
        launches = dict(fs.LAUNCHES)
        pairs = list(zip(trues, preds))[:held]
        rmse = [float(np.sqrt(np.mean((t - p) ** 2))) for t, p in pairs]
        mae = [float(np.mean(np.abs(t - p))) for t, p in pairs]
        log(f"[{card}] canary {name}: {cfg['NeuralNetwork']['Training']['num_epoch']} epochs, "
            f"{n} samples (seed {data_seed}), {state.step} steps, run_training + "
            f"run_prediction {wall:.3f} s; head RMSE {[round(x, 4) for x in rmse]} (< "
            f"{rmse_max}), sample MAE {[round(x, 4) for x in mae]}"
            f"{f' (< {mae_max})' if mae_max is not None else ' (not held)'}; launches "
            f"{launches}")
        if check and (max(rmse) >= rmse_max or (mae_max is not None and max(mae) >= mae_max)):
            raise AssertionError(f"canary {name} missed the reference thresholds")
        per_step = launches_per_train_step(
            _model_kind(cfg), int(cfg["NeuralNetwork"]["Architecture"]["num_conv_layers"]))
        missing = [k for k, v in per_step.items() if v and launches[k] <= 0]
        if device == "cuda" and missing:
            raise AssertionError(f"canary {name}: {missing} not launched: {launches}")
        out[name] = {"seconds": wall, "rmse": rmse, "mae": mae}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    t_start = time.perf_counter()
    dev = device_phase(torch)
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.config import update_config

    pkg = Path(hydragnn_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise SystemExit(f"chip_smoke: hydragnn_tpu_torch imported from {pkg}, not this checkout")
    build_phase()
    _, _, loaders, samples = prepare(args.seed)
    n_max = update_config(qm9_config("gps"), loaders[0].samples)[
        "NeuralNetwork"]["Architecture"]["max_graph_nodes"]
    entries, kernel_times = kernel_phase(torch, *bucket_batches(loaders, samples), n_max=n_max)
    served, trained = {}, {}
    for kind in MODELS:
        served[kind] = serving_phase(torch, "cuda", args.seed, kind, card=dev["smi"])
        trained[kind] = training_phase(torch, "cuda", args.seed, kind, kernel_times,
                                       card=dev["smi"])
    canary_phase(torch, "cuda", card=dev["smi"])
    for e in entries:
        name = e["name"]
        # launches: the three training runs (run_training) together; the
        # serving runs' counts and the per-model rates beside them
        e["launches"] = sum(trained[k]["launches"][name] for k in MODELS)
        e["launches_serving"] = sum(served[k]["launches"][name] for k in MODELS)
        e["launches_per_served_batch"] = {
            k: served[k]["launches"][name] / served[k]["batches"] for k in MODELS}
        e["launches_per_train_step"] = {k: trained[k]["per_step"][name] for k in MODELS}
        for kind in MODELS:
            layers = trained[kind]["layers"]
            if launches_per_train_step(kind, layers)[name] and \
                    trained[kind]["launches"][name] <= 0:
                raise AssertionError(f"{name} was not launched on {kind}'s training path")
            if launches_per_forward(kind, layers)[name] and served[kind]["launches"][name] <= 0:
                raise AssertionError(f"{name} was not launched on {kind}'s serving path")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to the result lines")
    log(dev["smi"])  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                              "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
