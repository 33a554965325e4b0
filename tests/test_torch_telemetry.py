"""The port's telemetry plane on the CPU, held against the JAX package's
(``hydragnn_tpu/telemetry``) on the same inputs.

* the slice: one tiny GIN config, seed and data through both packages'
  ``run_training`` with ``Telemetry`` on (the port's model holding the JAX
  run's initial parameters through ``convert.load_jax_variables``): the
  two ``events.jsonl`` have the same kinds in the same order and the same
  keys per kind, equal ``epoch``, ``raw_batches``, ``skipped`` and ``lr``
  (fp32), losses within ``tests/test_torch_train_loop.py``'s tolerances;
  the two ``trace.json`` have the same span names; the registries the same
  metric names and labels;
* the CLI: each package's CLI renders a journal (with its trace), a fleet
  of journals and a ledger written by the other identically;
* the ledger: ``diff`` gives the JAX verdicts on the same pair of ledger
  files (a 3% inflation fails, a shrinkage is an improvement) and the CLIs
  exit alike; the CPU ``flops`` of a tiny GIN train step equals a hand
  count of its dense products plus B1's and B2's ``cost(...)``; a kernel
  wrapper hides its plain version from the counters on the CPU;
* the journal: the torn tail, threads' seq order, the disabled no-op, env
  over config, the config block's unknown keys;
* the loop, the guard, the elastic controller, the capture sentinel, the
  server: the records the JAX package writes, from the port's CPU route.

The fleet, the wire and the store are ``tests/test_torch_trace_propagation.py``.
Each test runs in isolated planes of both packages (``port_telemetry``);
every journal is closed and every thread joined.
"""

import copy
import importlib
import json
import os
import threading

import numpy as np
import pytest
import torch

import hydragnn_tpu.telemetry as jtel
import hydragnn_tpu_torch.telemetry as tel
import torch_port_util as tpu
from hydragnn_tpu_torch.datasets import deterministic_graph_data
from hydragnn_tpu_torch.telemetry import ledger
from hydragnn_tpu_torch.telemetry.journal import EventJournal, read_journal
from hydragnn_tpu_torch.utils import flags
from hydragnn_tpu_torch.utils import tracer as tr
from test_torch_train_step import single_head_config
from torch_port_util import joined_threads, port_telemetry  # noqa: F401  (fixtures)

TRAIN_RTOL = 1e-4  # tests/test_torch_train_loop.py's train-loss tolerance
EVAL_RTOL = 6e-2   # its AdamW validation/test tolerance (the reason is in its docstring)


@pytest.fixture(autouse=True)
def _fresh(joined_threads, port_telemetry, monkeypatch):
    """Both planes isolated and following the env; no ledger path armed."""
    monkeypatch.delenv("HYDRAGNN_LEDGER", raising=False)
    with jtel.isolate():
        jtel.configure(None)
        tel.configure(None)
        yield


def _tiny_config(epochs: int = 2) -> dict:
    cfg = single_head_config()
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = epochs
    cfg["Telemetry"] = {"trace_events": True}
    return cfg


def _run_dir(root) -> str:
    (name,) = [d for d in os.listdir(root) if d.startswith("GIN")]
    return os.path.join(root, name)


# -- the slice: run_training of both packages ---------------------------------


def test_run_training_journal_trace_and_registry_match_jax(tmp_path, monkeypatch):
    jrt = importlib.import_module("hydragnn_tpu.run_training")
    prt = importlib.import_module("hydragnn_tpu_torch.run_training")
    cfg = _tiny_config()
    samples = deterministic_graph_data(number_configurations=64, seed=7)
    init = {}
    create = jrt.create_train_state

    def keep_init(*args, **kwargs):
        init["state"] = state = create(*args, **kwargs)
        return state

    monkeypatch.setattr(jrt, "create_train_state", keep_init)
    monkeypatch.chdir(tmp_path)
    jrt.run_training(copy.deepcopy(cfg), samples=tpu.jax_samples_copy(samples))
    jsnap = jtel.snapshot()
    variables = {"params": init["state"].params, "batch_stats": init["state"].batch_stats}
    monkeypatch.setattr(prt, "create_model_config",
                        lambda config, device, seed: tpu.port_model_from_jax(config, variables))
    prt.run_training(copy.deepcopy(cfg), samples=samples, device="cpu",
                     path=str(tmp_path / "port"))
    psnap = tel.snapshot()

    jdir, pdir = _run_dir(tmp_path / "logs"), _run_dir(tmp_path / "port")
    jrecs = read_journal(os.path.join(jdir, "events.jsonl"))
    precs = read_journal(os.path.join(pdir, "events.jsonl"))
    assert [r["kind"] for r in precs] == [r["kind"] for r in jrecs] == [
        "run_start", "epoch", "epoch", "run_end"]
    assert [r["seq"] for r in precs] == list(range(len(precs)))
    for p, j in zip(precs, jrecs):
        assert sorted(p) == sorted(j), p["kind"]
        if p["kind"] != "epoch":
            continue
        assert (p["epoch"], p["raw_batches"], p["skipped"]) == (
            j["epoch"], j["raw_batches"], j["skipped"])
        assert np.float32(p["lr"]) == np.float32(j["lr"])
        np.testing.assert_allclose(p["train_loss"], j["train_loss"], rtol=TRAIN_RTOL)
        np.testing.assert_allclose([p["val_loss"], p["test_loss"]],
                                   [j["val_loss"], j["test_loss"]], rtol=EVAL_RTOL)

    def names(run_dir):
        with open(os.path.join(run_dir, "trace.json")) as f:
            return {e["name"] for e in json.load(f)["traceEvents"]}

    assert names(pdir) == names(jdir) == {"train", "dataload", "validate", "test"}

    def series(snap):
        return {sec: {name: sorted(labels) for name, labels in snap[sec].items()}
                for sec in snap}

    assert series(psnap) == series(jsnap)
    assert psnap["counters"]["train_epochs_total"] == {"": 2}


# -- the CLI: each package's renders the other's files alike ------------------


def _write_journal(pkg, root, run_id):
    """A journal with every section the report renders, and its trace."""
    journal = pkg.open_journal(file=os.path.join(root, "events.jsonl"), run_id=run_id)
    pkg.emit("run_start", log_name="x", world=1)
    for epoch in range(2):
        pkg.set_context(epoch=epoch)
        pkg.emit("epoch", epoch=epoch, train_loss=0.5 / (epoch + 1), duration_s=1.25,
                 raw_batches=8, skipped=0, lr=1e-3, val_loss=0.25)
    pkg.set_context(recovery_id="rec1")
    pkg.emit("fault", fault="device_loss", device=2)
    pkg.emit("recovery_phase", phase="draining", detail="device_loss")
    pkg.emit("recovery", mode="remesh", recovery_ms=120.0, faults=["device_loss"])
    pkg.set_context(recovery_id=None)
    pkg.emit("shed", model="gin", reason="queue_full")
    pkg.emit("failover", replica=1, error="ConnectionError")
    with pkg.scoped_context(request_id="abcd1234"):
        pkg.emit("fleet_admit", model="gin")
        pkg.emit("fleet_reply", model="gin", replica=0, latency_s=0.002)
    pkg.emit("run_end", log_name="x")
    pkg.set_trace_enabled(True)
    pkg.add_span("train", 1.0, 0.5)
    pkg.add_span("dataload", 1.0, 0.125)
    pkg.save_trace(os.path.join(root, "trace.json"))
    pkg.close_journal()
    return journal.path


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_cli_renders_the_other_packages_files_identically(tmp_path, capsys, writer):
    from hydragnn_tpu.telemetry import cli as jcli
    from hydragnn_tpu_torch.telemetry import cli

    pkg = jtel if writer == "jax" else tel
    dirs = []
    for name in ("router", "replica0"):
        d = tmp_path / name
        d.mkdir()
        _write_journal(pkg, str(d), name)
        dirs.append(str(d))
    lg = pkg.ledger
    with lg.isolated_ledger():
        entry = {"model": "gin", "bucket": [8, 128, 2, 0], "backend": "cpu",
                 "precision": "fp32", "kind": "predict", "flops": 1e6,
                 "bytes_accessed": 2e6}
        lg.LEDGER._entries[lg.entry_key(entry)] = entry
        lg.save(str(tmp_path / "ledger.json"))
    for argv in ([dirs[0]], [dirs[0], "--full"], ["fleet", *dirs], ["ledger", str(tmp_path)]):
        outs = []
        for main in (cli.main, jcli.main):
            assert main(list(argv)) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1], argv
    assert "rec1:" in outs[0] or "cost ledger" in outs[0]


# -- the ledger ---------------------------------------------------------------


def test_ledger_diff_verdicts_and_cli_exit_codes_equal_jax(tmp_path, capsys):
    from hydragnn_tpu.telemetry import ledger as jledger
    from hydragnn_tpu.telemetry.cli import ledger_main as jledger_main
    from hydragnn_tpu_torch.telemetry.cli import ledger_main

    def doc(scale_flops, scale_peak):
        entries = [{"model": "run", "bucket": [64, 1024, 9, 0], "backend": "cuda",
                    "precision": "torch.bfloat16", "kind": kind,
                    "flops": 1e9 * scale_flops, "bytes_accessed": 3e8,
                    "peak_bytes": 5e7 * scale_peak}
                   for kind in ("train_step", "eval_step")]
        if scale_flops == 1.0:
            entries.append({"model": "run", "bucket": [8, 64, 2, 0], "backend": "cpu",
                            "precision": "fp32", "kind": "train_step", "flops": 10.0})
        return {"schema": ledger.SCHEMA_VERSION, "entries": entries}

    base, cur = tmp_path / "base.json", tmp_path / "cur.json"
    base.write_text(json.dumps(doc(1.0, 1.0)))
    cur.write_text(json.dumps(doc(1.03, 0.9)))
    got = ledger.diff(ledger.load(str(base)), ledger.load(str(cur)))
    want = jledger.diff(jledger.load(str(base)), jledger.load(str(cur)))
    assert got == want and not got["ok"]
    assert {d["metric"] for d in got["regressions"]} == {"flops"}
    assert {d["metric"] for d in got["improvements"]} == {"peak_bytes"}
    assert ledger.diff(ledger.load(str(base)), ledger.load(str(base)))["ok"]
    for argv, rc in (([str(cur), "--baseline", str(base)], 1),
                     ([str(base), "--baseline", str(base)], 0),
                     ([str(cur), "--baseline", str(base), "--tolerance", "0.05"], 0)):
        assert ledger_main(argv) == rc
        ours = capsys.readouterr().out
        assert jledger_main(argv) == rc
        assert capsys.readouterr().out == ours and "ledger diff" in ours


def _tiny_step(precision=torch.float32, n_samples=24):
    """A tiny GIN's state, train step and one collated CPU batch."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
    from hydragnn_tpu_torch.train.step import create_train_state, make_train_step

    cfg = single_head_config()
    loaders = dataset_loading_and_splitting(
        copy.deepcopy(cfg), samples=deterministic_graph_data(number_configurations=n_samples,
                                                             seed=3))
    aug = update_config(cfg, *(ld.samples for ld in loaders))
    model = create_model_config(aug, device="cpu", seed=0)
    state = create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"], seed=0)
    return aug, state, make_train_step(precision), next(iter(loaders[0]))


def test_cpu_flops_of_a_gin_step_equal_a_hand_count():
    """FLOPs of one tiny GIN train step = 2 M K N per Dense application
    forward, as much for its weight gradient and again for its input's
    gradient where the input needs one, plus per conv layer B1 forward
    (and its transposed launch where the layer's input needs a gradient)
    and B2's pooling, each at ``cost(...)``."""
    from hydragnn_tpu_torch.models.common import Dense
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    aug, state, step, batch = _tiny_step()
    arch = aug["NeuralNetwork"]["Architecture"]
    dense = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: dense.append(
                 (inp[0].numel() // mod.weight.shape[1], mod.weight.shape[1],
                  mod.weight.shape[0], inp[0].requires_grad)))
             for m in state.model.modules() if isinstance(m, Dense)]
    try:
        _, counts = ledger.count(step, state, batch)
    finally:
        for h in hooks:
            h.remove()
    dense_flops = sum(2 * m * k * n * (3 if grad else 2) for m, k, n, grad in dense)
    n, e, g = batch.num_nodes, batch.num_edges, batch.num_graphs
    hidden, layers = int(arch["hidden_dim"]), int(arch["num_conv_layers"])
    widths = [batch.x.shape[1]] + [hidden] * (layers - 1)
    kernel = {"gather_scatter_sum": [fs.cost("gather_scatter_sum", rows=n, cols=c, ids=e,
                                             out_rows=n, weight="edge") for c in widths],
              "gather_scatter_sum_bwd": [fs.cost("gather_scatter_sum_bwd", rows=n, cols=c,
                                                 ids=e, out_rows=n, weight="edge")
                                         for c in widths[1:]],
              "segment_sum": [fs.cost("segment_sum", rows=n, cols=hidden, ids=n, out_rows=g)]}
    assert counts["kernels"] == {k: {"calls": len(v), "flops": sum(f for f, _ in v),
                                     "bytes": sum(b for _, b in v)}
                                 for k, v in kernel.items()}
    assert counts["dense_flops"] == dense_flops > 0
    from hydragnn_tpu_torch import capture
    from torch.utils.flop_counter import FlopCounterMode

    with capture.preserved(state), FlopCounterMode(display=False) as fc:
        step(state, batch)  # the plain versions hold no product FlopCounterMode counts
    assert fc.get_total_flops() == dense_flops
    assert counts["flops"] == dense_flops + sum(f for v in kernel.values() for f, _ in v)
    assert counts["bytes_accessed"] > counts["kernel_bytes"] > 0


def test_kernel_regions_hide_the_plain_versions_and_report_cost():
    """On the CPU a wrapper's plain version runs under the counter, which
    sees only the kernel's ``cost(...)``; outside a counter nothing is
    counted and the output is the plain version's."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.ops import fused_softmax as fsm
    from hydragnn_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator().manual_seed(0)
    h = torch.randn(10, 4, generator=gen)
    ids = torch.tensor([0, 1, 1, 3, 9, 9], dtype=torch.int32)
    x = torch.randn(5, 8, generator=gen)
    w_q, s_w = qm.quantize_weight(torch.randn(8, 3, generator=gen))
    with ledger.CostCounter() as c:
        out = fs.fused_segment_sum(h[:6], ids, 10)
        sm = fsm.segment_softmax(h[:6], ids, 10)
        q = qm.quant_dense(x, w_q, s_w, 0.05)
    r = c.result()
    assert r["dense_flops"] == 0 and r["dense_bytes"] == 0
    assert r["kernels"] == {
        "segment_sum": dict(zip(("flops", "bytes"), fs.cost(
            "segment_sum", rows=6, cols=4, ids=6, out_rows=10)), calls=1),
        "segment_softmax": dict(zip(("flops", "bytes"), fsm.cost(
            "segment_softmax", rows=6, cols=4)), calls=1),
        "quant_dense": dict(zip(("flops", "bytes"), qm.cost(5, 8, 3, 4)), calls=1)}
    assert torch.equal(out, fs.plain_segment_sum(h[:6], ids, 10))
    assert torch.equal(q, qm.reference_quant_dense(x, w_q, s_w, 0.05, None))
    assert sm.shape == (6, 4)
    assert ledger._OPEN == 0


def test_cost_formulas_are_the_kernel_tables_counts():
    """``cost(...)`` at the kernel table's shapes gives the counts the
    table's bound was taken from (qm9 top bucket, C = 64, fp32)."""
    from hydragnn_tpu_torch.ops import fp8_matmul as f8
    from hydragnn_tpu_torch.ops import fused_cell_list as fcl
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.ops import fused_softmax as fsm
    from hydragnn_tpu_torch.ops import quant_matmul as qm

    n, e, g = 1864, 17792, 65
    assert fs.cost("gather_scatter_sum", rows=n, cols=64, ids=e, out_rows=n,
                   weight="edge") == (2 * e * 64, n * 64 * 4 + 2 * e * 4 + e * 4 + n * 64 * 4)
    assert fs.cost("gather_scatter_sum", rows=n, cols=64, ids=e, out_rows=n,
                   weight="channel")[1] == n * 64 * 8 + 2 * e * 4 + e * 64 * 4
    assert fs.cost("segment_sum", rows=n, cols=64, ids=n, out_rows=g) == (
        n * 64, n * 64 * 4 + n * 4 + g * 64 * 4)
    assert fsm.cost("segment_softmax", rows=e, cols=6) == (5 * e * 6, 2 * e * 6 * 4 + e * 4)
    assert fsm.cost("masked_softmax", rows=g * 4 * 32, cols=32, mask_bytes=g * 32) == (
        5 * g * 4 * 32 * 32, 2 * g * 4 * 32 * 32 * 4 + g * 32)
    assert qm.cost(64, 64, 64, 2, bias=True) == (2 * 64 ** 3, 64 * 64 * 2 + 64 * 64 + 2 * 64 * 4
                                                 + 64 * 64 * 4)
    assert f8.cost(64, 64, 64) == (2 * 64 ** 3, 64 * 64 * 4 + 64 * 64 + 64 * 4 + 4 + 64 * 64 * 4)
    assert fcl.cost(1000, 512, 30000, 400000) == (48 * 400000, 28 * 1000 + 8 * 512 + 8 * 30000
                                                  + 84)
    with pytest.raises(ValueError, match="unknown kernel"):
        fs.cost("softmax", rows=1, cols=1, ids=1, out_rows=1)


def test_ledger_probe_of_an_eager_run_and_serving_warmup_on_cpu(tmp_path, monkeypatch):
    """``HYDRAGNN_LEDGER`` naming a path arms the one-shot train-step probe
    of the CPU route (one entry, saved there and next to the journal), and
    a CPU server's warm-up counts each bucket's eager run: ``predict``
    entries with ``flops`` and no ``peak_bytes``, ``serve_warmup`` in the
    journal, ``serve_requests`` counters and ``serve_*`` gauges."""
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.serve import PredictionServer
    from hydragnn_tpu_torch.train import loop

    monkeypatch.setattr(loop, "_LEDGER_PROBED", False)
    monkeypatch.setenv("HYDRAGNN_LEDGER", str(tmp_path / "probe.json"))
    samples = deterministic_graph_data(number_configurations=40, seed=7)
    state, model, aug = run_training(_tiny_config(1), samples=samples, device="cpu",
                                     path=str(tmp_path))
    doc = ledger.load(str(tmp_path / "probe.json"))
    assert [e["kind"] for e in doc["entries"]] == ["train_step"]
    probe = doc["entries"][0]
    assert probe["backend"] == "cpu" and probe["flops"] > 0 and "peak_bytes" not in probe
    assert probe["captures_at_capture"] == 0 and doc["captures"] == {"captures": 0}
    monkeypatch.setattr(loop, "_LEDGER_PROBED", False)

    tel.open_journal(file=str(tmp_path / "serve" / "events.jsonl"), run_id="serve")
    server = PredictionServer({"flush_ms": 1.0}, device="cpu")
    server.add_model("gin", model, aug, samples=samples[:8], max_buckets=2)
    server.warmup()
    try:
        server.start()
        server.predict("gin", samples[:3])
    finally:
        server.stop()
    stats = server.stats()
    tel.close_journal()
    predict = [e for e in ledger.entries() if e["kind"] == "predict"]
    assert len(predict) == len(stats["gin"]["buckets"]) >= 1
    assert all(e["model"] == "gin" and e["flops"] > 0 and "peak_bytes" not in e
               for e in predict)
    kinds = [r["kind"] for r in read_journal(str(tmp_path / "serve" / "events.jsonl"))]
    assert kinds == ["serve_warmup"]
    snap = tel.snapshot()
    assert snap["counters"]["serve_requests"]["event=served,model=gin"] == 3
    assert snap["gauges"]["serve_served"]["model=gin"] == 3


def test_peak_bytes_reset_the_peak_statistic_only_under_an_explicit_path(tmp_path,
                                                                          monkeypatch):
    """A capture's ledger entry on the card measures ``peak_bytes`` (and so
    resets ``torch.cuda``'s process-wide peak statistic) only when
    ``HYDRAGNN_LEDGER`` names a path; the default plane leaves the
    statistic alone and records no ``peak_bytes``. ``torch.cuda``'s memory
    statistics are stood in for on this card-less host; the counted run's
    seconds add to ``counted_totals``."""
    resets = []
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 1_000)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: 5_096)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda device=None: resets.append(device))
    cuda = torch.device("cuda")
    key = dict(model="gin", bucket=(8, 16, 2), precision="torch.float32")
    before = ledger.counted_totals()
    _, counts = ledger.count(lambda x: x @ x, torch.ones(4, 4))
    after = ledger.counted_totals()
    assert after["runs"] == before["runs"] + 1 and after["seconds"] > before["seconds"]
    with ledger.measured_capture(cuda, kind="train_step", **key) as slot:
        slot["counts"] = counts
    assert resets == [] and "peak_bytes" not in ledger.entries()[0]
    monkeypatch.setenv("HYDRAGNN_LEDGER", str(tmp_path / "ledger.json"))
    with ledger.measured_capture(cuda, kind="eval_step", **key) as slot:
        slot["counts"] = counts
    assert resets == [cuda]
    assert {e["kind"]: e.get("peak_bytes") for e in ledger.entries()} == {
        "eval_step": 4_096, "train_step": None}
    assert all(e["flops"] == 2 * 4 * 4 * 4 for e in ledger.entries())


def _calls_named(node, names: tuple) -> list[int]:
    import ast

    return sorted(n.lineno for n in ast.walk(node) if isinstance(n, ast.Call)
                  and isinstance(n.func, (ast.Attribute, ast.Name))
                  and (n.func.attr if isinstance(n.func, ast.Attribute) else n.func.id) in names)


def test_no_chip_smoke_peak_read_spans_a_capture():
    """Every function of ``chip_smoke.py`` that reads
    ``max_memory_allocated`` reset the statistic itself before the read,
    with no capture (a ``Dispatch``, ``StepGraphs`` or ``run_training``
    call) between its reset and its read, so an armed ledger's reset at a
    capture cannot move what it reads."""
    import ast

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    readers = 0
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        reads = _calls_named(fn, ("max_memory_allocated",))
        if not reads:
            continue
        readers += 1
        resets = _calls_named(fn, ("reset_peak_memory_stats",))
        captures = _calls_named(fn, ("Dispatch", "StepGraphs", "run_training",
                                     "train_validate_test"))
        for line in reads:
            last = max((r for r in resets if r < line), default=None)
            assert last is not None, (fn.name, line)
            assert not [c for c in captures if last < c < line], (fn.name, last, line)
    assert readers >= 1


# -- the journal --------------------------------------------------------------


def test_journal_torn_tail_thread_order_and_context(tmp_path):
    path = str(tmp_path / "events.jsonl")
    journal = EventJournal(path, run_id="r")
    tel.set_context(epoch=3)

    def emit_many(k):
        for i in range(50):
            journal.emit("tick", worker=k, i=i)

    threads = [threading.Thread(target=emit_many, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with tel.scoped_context(request_id="q1"):
        journal.emit("scoped")
    journal.close()
    with open(path, "a") as f:
        f.write('{"kind": "torn", "se')  # a SIGKILL mid-write
    recs = read_journal(path)
    assert [r["seq"] for r in recs] == list(range(201))
    assert all(r["epoch"] == 3 and r["run_id"] == "r" for r in recs[:200])
    assert recs[-1]["request_id"] == "q1" and recs[-1]["epoch"] == 3
    for k in range(4):
        assert [r["i"] for r in recs if r.get("worker") == k] == list(range(50))
    assert jtel.read_journal(path) == recs


def test_disabled_plane_is_a_noop_and_env_beats_config(tmp_path, monkeypatch):
    from hydragnn_tpu.telemetry import TelemetryConfig as JaxConfig

    from hydragnn_tpu_torch.telemetry import TelemetryConfig

    monkeypatch.setenv("HYDRAGNN_TELEMETRY", "0")
    journal = tel.open_journal(file=str(tmp_path / "events.jsonl"))
    assert tel.emit("x") is None and tel.counter("c") is tel.NOOP
    tel.publish("p", {"a": 1})
    assert tel.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert not tel.trace_enabled() and not tel.propagate_enabled()
    assert not ledger.capture_enabled()
    tel.close_journal()
    assert read_journal(journal.path) == []

    monkeypatch.setenv("HYDRAGNN_TRACE_EVENTS", "1")
    monkeypatch.setenv("HYDRAGNN_LEDGER", "off")
    for cls in (TelemetryConfig, JaxConfig):
        got = cls.from_config({"Telemetry": {"enabled": True, "trace_events": False}})
        assert (got.enabled, got.trace_events, got.ledger) == (False, True, False)
    monkeypatch.delenv("HYDRAGNN_TELEMETRY")
    applied = tel.configure({"Telemetry": {"trace_propagate": False}})
    assert tel.enabled() and tel.trace_enabled() and not tel.propagate_enabled()
    assert applied.trace_events is True
    tel.configure(None)
    assert tel.propagate_enabled()


def test_config_block_defaults_and_unknown_keys_equal_jax():
    from hydragnn_tpu.telemetry import TelemetryConfig as JaxConfig
    from hydragnn_tpu.telemetry import telemetry_config_defaults as jax_defaults

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.telemetry import TelemetryConfig, telemetry_config_defaults

    assert telemetry_config_defaults() == jax_defaults() == {
        "enabled": True, "journal": True, "trace_events": False, "trace_propagate": True,
        "ledger": True}
    for cls in (TelemetryConfig, JaxConfig):
        with pytest.raises(ValueError, match="Unknown Telemetry key"):
            cls.from_config({"Telemetry": {"journl": True}})
        with pytest.raises(ValueError, match="unrecognized telemetry config keys"):
            cls.from_config({"bogus": 1})
        with pytest.raises(ValueError, match="must be a bool"):
            cls(enabled="yes").validate()
    cfg = single_head_config()
    samples = deterministic_graph_data(number_configurations=8, seed=1)
    assert update_config(cfg, samples)["Telemetry"] == telemetry_config_defaults()
    cfg["Telemetry"] = {"journl": True}
    with pytest.raises(ValueError, match="Unknown Telemetry key"):
        update_config(cfg, samples)
    for name in ("TELEMETRY", "TRACE_EVENTS", "TRACE_PROPAGATE", "LEDGER", "TRACE_LEVEL",
                 "COMPILE_SENTINEL"):
        from hydragnn_tpu.utils import flags as jflags

        assert getattr(flags, name).default == getattr(jflags, name).default, name


# -- the loop, the guard, the controller, the sentinel ------------------------


def test_superstep_guard_rollback_and_profiler_records(tmp_path, monkeypatch):
    """K = 2: one ``dispatch_block`` per block and ``stage_block`` spans; a
    NaN batch streak journals ``guard_skip``, ``divergence`` and
    ``rollback`` (with ``divergence_rollbacks_total``); at
    ``HYDRAGNN_TRACE_LEVEL`` 1 the first epoch's profiler trace is
    written."""
    from test_torch_resilience import _loop

    from hydragnn_tpu_torch.resilience import FaultPlan, Resilience
    from hydragnn_tpu_torch.train.loop import train_validate_test

    monkeypatch.setenv("HYDRAGNN_TRACE_LEVEL", "1")
    tel.set_trace_enabled(True)
    nn, state, loaders, path = _loop(tmp_path)
    nn["Training"]["steps_per_dispatch"] = 2
    res = Resilience.from_config(nn["Training"])
    res.max_consecutive_skips, res.checkpoint_every_epoch = 2, True
    res.chaos = FaultPlan.parse('[{"fault": "nan_batch", "epoch": 1, "times": 4}]')
    journal = tel.open_journal("loop", path=path)
    train_validate_test(state, *loaders, nn, "loop", path=path, resilience=res)
    tel.close_journal()
    recs = read_journal(journal.path)
    kinds = [r["kind"] for r in recs]
    assert {"dispatch_block", "guard_skip", "divergence", "rollback", "epoch"} <= set(kinds)
    blocks = [r for r in recs if r["kind"] == "dispatch_block"]
    assert all(r["k"] == 2 and r["step"] == 2 * r["block"] for r in blocks)
    assert kinds.index("divergence") < kinds.index("rollback")
    assert [r["epoch"] for r in recs if r["kind"] == "epoch"] == [0, 1, 2]
    assert tel.snapshot()["counters"]["divergence_rollbacks_total"] == {"": res.rollbacks} \
        and res.rollbacks >= 1
    assert {"stage_block", "dataload", "train"} <= {e["name"] for e in tel.trace_events()}
    assert os.listdir(os.path.join(path, "loop", "profile"))


def test_capture_sentinel_strict_raises_after_warmup(tmp_path, monkeypatch):
    """The loop's sentinel over a capture count that grows every epoch:
    ``warn`` journals ``compile_sentinel`` (JAX's ``new_lowerings`` field)
    per epoch, the warm-up epoch flagged; ``strict`` raises at epoch 1."""
    from test_torch_resilience import _loop

    from hydragnn_tpu_torch import capture
    from hydragnn_tpu_torch.analysis import RecompileError
    from hydragnn_tpu_torch.analysis import sentinel
    from hydragnn_tpu_torch.train.loop import train_validate_test

    count = {"n": 0}

    def growing():
        count["n"] += 1
        return {"captures": count["n"]}

    monkeypatch.setattr(sentinel, "compile_counts", growing)
    for mode in ("warn", "strict"):
        monkeypatch.setenv("HYDRAGNN_COMPILE_SENTINEL", mode)
        nn, state, loaders, path = _loop(tmp_path / mode, num_epoch=2)
        journal = tel.open_journal("s", path=path)
        if mode == "warn":
            train_validate_test(state, *loaders, nn, "s", path=path)
        else:
            with pytest.raises(RecompileError, match="epoch 1 captured 1 new CUDA graph"):
                train_validate_test(state, *loaders, nn, "s", path=path)
        tel.close_journal()
        recs = [r for r in read_journal(journal.path) if r["kind"] == "compile_sentinel"]
        assert [(r["epoch"], r["new_lowerings"], r["warmup"]) for r in recs] == [
            (0, 1, True), (1, 1, False)]
    monkeypatch.setenv("HYDRAGNN_COMPILE_SENTINEL", "bogus")
    nn, state, loaders, path = _loop(tmp_path / "bogus", num_epoch=1)
    with pytest.raises(ValueError, match="COMPILE_SENTINEL"):
        train_validate_test(state, *loaders, nn, "s", path=path)
    monkeypatch.undo()
    assert sentinel.compile_counts() == {"captures": capture.total_captures()}
    # the region guard the served and superstep paths use (JAX's
    # no_recompile(0)): a capture asked for inside it raises, naming it
    capture._check_guards("outside any region")
    with capture.no_new_captures("a warm pass"):
        with pytest.raises(capture.NewCaptureError, match="a warm pass"):
            capture._check_guards("bucket (8, 16, 2)")
    capture._check_guards("after the region")


def test_controller_recovery_records_correlate(tmp_path):
    """The elastic controller driven directly: one ``recovery_id`` spans
    the fault, the phases, a checkpoint record and the summary, and
    returning to running retires it; both CLIs render the recovery."""
    from hydragnn_tpu.telemetry.cli import render_report as jrender

    from hydragnn_tpu_torch.resilience.elastic import ElasticController, Fault
    from hydragnn_tpu_torch.telemetry.cli import render_report

    journal = tel.open_journal("ctl", path=str(tmp_path))
    ctl = ElasticController(ranks=list(range(4)))
    ctl.set_state("running")
    ctl.signal(Fault(kind="device_loss", device=2, detail="chaos"))
    tel.emit("preempt_checkpoint", epoch=1, raw_done=8, mid_epoch=True)
    faults = ctl.take_pending()
    ctl.set_state("re-mesh")
    ctl.apply(faults[0])
    ctl.note_recovery(faults, "remesh", 120.0, {"epoch": 1, "n_dev": 4})
    ctl.set_state("resumed", "remesh in 120 ms")
    ctl.set_state("running")
    tel.emit("epoch", epoch=1, train_loss=0.1)
    tel.close_journal()
    recs = read_journal(journal.path)
    rec1 = [r for r in recs if r.get("recovery_id") == "rec1"]
    assert [(r["kind"], r.get("phase")) for r in rec1] == [
        ("fault", None), ("recovery_phase", "draining"), ("preempt_checkpoint", None),
        ("recovery_phase", "re-mesh"), ("recovery", None), ("recovery_phase", "resumed")]
    assert rec1[4]["mode"] == "remesh" and rec1[4]["lost_indices"] == [2]
    assert all("recovery_id" not in r for r in recs if r["seq"] > rec1[-1]["seq"])
    assert tel.snapshot()["counters"]["elastic_recoveries_total"] == {"mode=remesh": 1}
    report = render_report(recs)
    assert report == jrender(recs) and "rec1:" in report and "mode=remesh" in report


def test_nested_spans_and_print_utils(capsys):
    """Spans nest per thread and become Chrome trace events (host clock,
    no device wait) tagged with the context; timers aggregate;
    ``print_distributed`` prints on rank 0; ``device_memory_summary``
    says when there is no card."""
    from hydragnn_tpu_torch.utils.print_utils import (
        device_memory_summary, iterate_tqdm, print_distributed)

    tel.set_trace_enabled(True)
    tel.set_context(epoch=7)
    with tr.span("train"):
        for _ in tr.timed_iter(range(3)):
            pass
    events = tel.trace_events()
    assert [e["name"] for e in events] == ["dataload"] * 4 + ["train"]
    assert all(e["ph"] == "X" and e["args"]["epoch"] == 7 for e in events)
    assert tr.summary()["dataload"]["count"] == 4
    print_distributed(1, "hello")
    assert capsys.readouterr().out == "hello\n"
    assert list(iterate_tqdm(range(2), 0)) == [0, 1]
    if not torch.cuda.is_available():
        assert "no CUDA device" in device_memory_summary()
