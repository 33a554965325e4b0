#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hydragnn_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; the last line of standard output is the
device JSON only when every phase passed):

1. device: name, count, power limit; TF32 off for matmuls and cuDNN;
2. build: nvcc builds ``hydragnn_tpu_torch/csrc/*.cu`` from this checkout;
3. kernels: each CUDA kernel's wrapper against its plain PyTorch version at
   the serving path's shapes (a collated QM9-like batch at the top pad
   bucket), fp32 and bf16, scalar and per-channel weights, unsorted ids and
   empty rows; device times per call (CUDA-graph replay between CUDA events)
   beside the plain version, a one-call PyTorch yardstick and the memory
   bound;
4. serving: the QM9 GIN of ``examples/qm9/qm9.json`` at full width (random
   weights from ``--seed``) behind ``PredictionServer``; at least 256
   concurrent requests; served answers against ``Predictor.outputs`` on the
   same padded batches; launch counts of both kernels per served batch; the
   card's answers against the port's CPU route on one batch; one
   ``run_prediction`` pass over the same samples.

The script imports only ``hydragnn_tpu_torch``, torch and numpy, and needs no
network.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
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


def log(msg: str) -> None:
    print(msg, flush=True)


def qm9_like_samples(n: int, seed: int, radius: float, max_neighbours: int):
    """``n`` QM9-sized molecules: 9-29 atoms uniform in a 6 Å box, ``Z`` in
    1..9 as the one node feature, a random graph target, radius graphs from
    the port's ``radius_graph``."""
    from hydragnn_tpu_torch.graphs.graph import GraphSample
    from hydragnn_tpu_torch.graphs.radius import radius_graph

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        na = int(rng.integers(9, 30))
        pos = rng.uniform(0.0, 6.0, size=(na, 3))
        z = rng.integers(1, 10, size=(na, 1)).astype(np.float32)
        s, r, sh = radius_graph(pos, radius=radius, max_neighbours=max_neighbours)
        out.append(GraphSample(x=z, pos=pos, senders=s, receivers=r, edge_shifts=sh,
                               graph_y=rng.normal(size=(1,))))
    return out


def qm9_config() -> dict:
    """``examples/qm9/qm9.json`` with its dataset replaced by the in-memory
    QM9-like set (same node and graph features)."""
    from hydragnn_tpu_torch.config import load_config

    cfg = load_config(str(QM9_CONFIG))
    cfg["Dataset"] = {
        "name": "qm9_like_in_memory",
        "format": "in_memory",
        "node_features": cfg["Dataset"]["node_features"],
        "graph_features": cfg["Dataset"]["graph_features"],
    }
    return cfg


def prepare(seed: int, n_samples: int = 512):
    """(raw config, augmented config, loaders, samples) of the QM9 GIN."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = qm9_config()
    arch = cfg["NeuralNetwork"]["Architecture"]
    samples = qm9_like_samples(n_samples, seed, float(arch["radius"]),
                               int(arch["max_neighbours"]))
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
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return {"kind": name, "count": count, "smi": smi}


# -- phase 2: build ----------------------------------------------------------


def build_phase() -> None:
    from hydragnn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s ({_build.BUILD_LOG.get('path')})")
    log(f"nvcc: {_build.BUILD_LOG.get('command', '(cached)')}")
    for line in _build.BUILD_LOG.get("ptxas", "").splitlines():
        log(f"ptxas: {line}")


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
    tol = TOL[dtype_name]
    g = got[:rows].float()
    w = want[:rows].float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: kernel output not finite")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(torch.allclose(g, w, **tol))
    log(f"  {name}: max|kernel-plain|={err:.3e} (rtol={tol['rtol']}, atol={tol['atol']}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return err


def kernel_phase(torch, batch, small=None, timing: bool = True) -> list[dict]:
    """Every kernel of the serving path against its plain version on the
    card, at ``batch``'s shapes (timed there and, for the log, at the
    ``small`` batch of the smallest bucket). Returns the kernels' JSON
    entries."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs

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

    # kernel 2: segment sum over the graph CSR (pooling) and the node CSR
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
    results["segment_sum"] = max(errs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if not timing:
        return []

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

    # conv layer 0 of the bf16 predict step: bf16, C = 1
    h0 = feats(1, torch.bfloat16)
    w0 = mask.to(torch.bfloat16)
    t_k = graph_time_ms(torch, lambda: fs.gather_scatter_sum(
        h0, b.senders, b.receivers, n, weight=w0, index=recv_idx))
    t_p = graph_time_ms(torch, lambda: fs.plain_gather_scatter_sum(
        h0, b.senders, b.receivers, n, w0))
    log(f"  gather_scatter_sum @ h[{n},1] bf16 (conv layer 0): kernel {t_k * 1e3:.2f} us, "
        f"plain {t_p * 1e3:.2f} us")
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
        log(f"  smallest bucket N={sn} E={s_b.num_edges}: gather_scatter_sum kernel "
            f"{t_k * 1e3:.2f} us / plain {t_p * 1e3:.2f} us; segment_sum kernel "
            f"{t_k2 * 1e3:.2f} us / plain {t_p2 * 1e3:.2f} us")

    entries = []
    for name, src_line, k in (
        ("gather_scatter_sum", "hydragnn_tpu/ops/fused_scatter.py:87", k1),
        ("segment_sum", "hydragnn_tpu/ops/fused_scatter.py:378", k2),
    ):
        t_bytes = k["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = k["ops"] / FP32_FLOPS * 1e3
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "hydragnn_tpu_torch/csrc/segment_reduce.cu",
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
        log(f"  {name} @ {k['shape']}: kernel {k['ms'] * 1e3:.2f} us, plain "
            f"{k['plain_ms'] * 1e3:.2f} us, one-call yardstick {k['library_ms'] * 1e3:.2f} us, "
            f"bound {max(t_bytes, t_ops) * 1e3:.3f} us ({k['bytes']} B at 3.35 TB/s)")
    return entries


# -- phase 4: serving --------------------------------------------------------


def serving_phase(torch, device: str, seed: int, n_clients: int = 4,
                  card: str = "") -> dict:
    """The QM9 GIN behind ``PredictionServer``: warm-up, concurrent
    requests, served answers against ``Predictor.outputs``, launch counts."""
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.serve import PredictionServer, Predictor, ServingConfig
    from hydragnn_tpu_torch.serve.batcher import serving_collate

    cfg, aug, loaders, samples = prepare(seed)
    spec_arch = aug["NeuralNetwork"]["Architecture"]
    model = create_model_config(aug, device=device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {spec_arch['mpnn_type']} hidden {spec_arch['hidden_dim']} x "
        f"{spec_arch['num_conv_layers']} conv layers, {n_params} parameters, precision "
        f"{aug['NeuralNetwork']['Training']['precision']}, seed {seed}")

    server = PredictionServer(ServingConfig(queue_depth=2048, flush_ms=5.0), device=device)
    ep = server.add_model("qm9_gin", model, aug, samples=samples)
    log(f"buckets (n_node, n_edge, n_graph, n_triplet): {[b.as_tuple() for b in ep.buckets]}")
    t0 = time.perf_counter()
    server.warmup()
    log(f"warm-up: {time.perf_counter() - t0:.3f} s over {len(ep.buckets)} buckets")
    server.start()
    results: list = [None] * len(samples)
    try:
        fs.reset_launches()
        t_start = time.perf_counter()

        def client(k):
            futs = [(i, server.submit("qm9_gin", samples[i]))
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
        stats = server.stats()["qm9_gin"]
    finally:
        server.stop()

    if any(r is None for r in results):
        raise AssertionError("serving: some requests got no answer")
    n_batches = stats["batches"]
    log(f"served {stats['served']} requests in {n_batches} batches, failed {stats['failed']}, "
        f"shed {stats['shed']}, occupancy {stats['occupancy']:.3f}")
    if stats["served"] != len(samples) or stats["failed"]:
        raise AssertionError(f"serving: {stats}")
    for r in results:
        if not all(np.isfinite(np.asarray(h)).all() for h in r["heads"]):
            raise AssertionError("serving: non-finite answer")
    want = {"gather_scatter_sum": 4 * n_batches, "segment_sum": n_batches}
    log(f"launches during serving: {launches} (expected {want}: 4 conv layers and 1 "
        f"pooling per batch)")
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
    log(f"served vs Predictor.outputs on the same padded batches: max|diff|={worst:.3e} "
        f"(allowed {SERVE_ATOL})")
    if worst > SERVE_ATOL:
        raise AssertionError("serving: served answers differ from Predictor.outputs")

    lat = np.array([r["latency_s"] for r in results]) * 1e3
    graphs_per_s = len(samples) / wall
    log(f"[{card}] serving: {len(samples)} requests from {n_clients} client threads, "
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
    log(f"{device} fp32 forward vs the CPU route on one test batch: max|diff|={d:.3e} "
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
        b.csr("receivers")
        b.csr("batch")

    t_csr = wall_ms(build_csr)
    out = predictor.outputs(host_batch)
    t_split = wall_ms(lambda: predictor.split_graphs(out, [s.num_nodes for s in chunk]))
    log(f"[{card}] one served batch at the top bucket (median of 20, host clock): collate "
        f"{t_collate:.3f} ms, to device {t_h2d:.3f} ms, predict step {t_fwd:.3f} ms (of "
        f"which building the two CSR views {t_csr:.3f} ms), split to numpy {t_split:.3f} ms")

    # the batch evaluator over the same samples
    fs.reset_launches()
    t0 = time.perf_counter()
    error, _, trues, preds = run_prediction(copy.deepcopy(cfg), model,
                                                     samples=samples, device=device)
    rp_s = time.perf_counter() - t0
    rp_launches = dict(fs.LAUNCHES)
    n_rp = len(loaders[2])
    log(f"run_prediction: {preds[0].shape[0]} test graphs in {n_rp} batches, mse {error:.6f}, "
        f"{rp_s:.3f} s, launches {rp_launches}")
    if not np.isfinite(error) or preds[0].shape != trues[0].shape:
        raise AssertionError("run_prediction: bad result")
    if device == "cuda" and rp_launches != {"gather_scatter_sum": 4 * n_rp,
                                            "segment_sum": n_rp}:
        raise AssertionError(f"run_prediction: launch counts {rp_launches}")
    return {"launches": launches, "batches": n_batches}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    dev = device_phase(torch)
    import hydragnn_tpu_torch

    pkg = Path(hydragnn_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise SystemExit(f"chip_smoke: hydragnn_tpu_torch imported from {pkg}, not this checkout")
    build_phase()
    _, _, loaders, samples = prepare(args.seed)
    entries = kernel_phase(torch, *bucket_batches(loaders, samples))
    served = serving_phase(torch, "cuda", args.seed, card=dev["smi"])
    for e in entries:
        e["launches"] = served["launches"][e["name"]]
        if e["launches"] <= 0:
            raise AssertionError(f"{e['name']} was not launched on the serving path")
    log(dev["smi"])  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                              "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
