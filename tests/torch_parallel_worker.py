"""One rank of the port's 2-process ``gloo`` workers (not a test module).

``python tests/torch_parallel_worker.py RANK WORLD PORT`` joins a ``gloo``
group at ``tcp://127.0.0.1:PORT`` and then runs tasks read from stdin, one
JSON line each (``{"task": name, "in": path, "out": path}``): it loads the
inputs with ``torch.load``, runs the task on this rank, saves the outputs to
``out`` with its rank appended and answers ``DONE`` (or ``FAIL`` and the
traceback on one line). ``{"task": "quit"}`` ends it. It imports torch,
numpy and the port only, never JAX: the test modules compute the JAX
package's references in the pytest process (``torch_parallel_pool.py``).
"""

from __future__ import annotations

import copy
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)


def _batch(arrays: dict):
    from hydragnn_tpu_torch.graphs.batching import batch_from_arrays, batch_meta
    from hydragnn_tpu_torch.graphs.graph import FIELDS

    arrays = {f: np.ascontiguousarray(arrays[f]) for f in FIELDS}
    return batch_from_arrays(arrays, batch_meta(arrays))


def _model(inp: dict):
    from hydragnn_tpu_torch.models import create_model_config

    model = create_model_config(copy.deepcopy(inp["aug"]), device="cpu", seed=0)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in inp["state"].items()})
    return model


def _state(inp: dict, model):
    from hydragnn_tpu_torch.train.step import create_train_state

    return create_train_state(model, inp["opt"], seed=0)


def _numpy_state(model) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def _metrics(m: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in m.items()}


def task_data_step(inp: dict, rank: int) -> dict:
    """The parallel eval step on this rank's first batch, then data-parallel
    train steps on this rank's batches (``batches[rank]``, one per step),
    replicated or FSDP, with or without SyncBatchNorm."""
    from hydragnn_tpu_torch.parallel.mesh import host_gather
    from hydragnn_tpu_torch.parallel.step import (bind_sync_batch_norm,
                                                  make_parallel_eval_step,
                                                  make_parallel_train_step, shard_state)

    model = _model(inp)
    state = _state(inp, model)
    shard_state(state, inp["opt"], param_mode=inp.get("mode", "replicated"),
                min_size_to_shard=inp.get("min_size", 2 ** 14))
    bind_sync_batch_norm(model)
    step = make_parallel_train_step(model)
    evals = _metrics(make_parallel_eval_step(model)(state, _batch(inp["batches"][rank][0])))
    batches = [_batch(b) for b in inp["batches"][rank]]
    steps = [_metrics(step(state, b)) for b in batches]
    return {"steps": steps, "eval": evals, "state": {k: v.numpy() for k, v in
                                                      host_gather(state).items()},
            "shards": [(tuple(s.param.shape), s.dim, tuple(s.shard.shape))
                       for s in state.layout.shards],
            "optimizer_params": sum(p.numel() for g in state.optimizer.param_groups
                                    for p in g["params"])}


def task_fsdp_resume(inp: dict, rank: int) -> dict:
    """FSDP steps on this rank's batches, uninterrupted and interrupted
    after ``split`` steps by a checkpoint (every rank saves, rank 0 writes
    under ``path``) that a fresh state loads before it shards, as
    ``run_training`` resumes; the replicated run's checkpoint at the split
    for comparison."""
    import torch.distributed as dist

    from hydragnn_tpu_torch.parallel.mesh import host_gather
    from hydragnn_tpu_torch.parallel.step import make_parallel_train_step, shard_state
    from hydragnn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    batches = [_batch(b) for b in inp["batches"][rank]]
    split = inp["split"]

    def fresh(mode, name=None):
        model = _model(inp)
        state = _state(inp, model)
        if name is not None:
            load_checkpoint(state, name, path=inp["path"])
        shard_state(state, inp["opt"], param_mode=mode)
        return state, make_parallel_train_step(model)

    whole, step = fresh("fsdp")
    losses = [float(step(whole, b)["loss"]) for b in batches]
    out = {"losses": losses, "state": {k: v.numpy() for k, v in host_gather(whole).items()}}
    for mode in ("fsdp", "replicated"):
        first, step = fresh(mode)
        for b in batches[:split]:
            step(first, b)
        # each rank's dropout generator at a state of its own (the GIN
        # draws no mask)
        torch.rand(rank + 3, generator=first.generator)
        generator = first.generator.get_state()
        save_checkpoint(first, mode, split, path=inp["path"])
        dist.barrier()
    saved = {m: torch.load(os.path.join(inp["path"], m, "checkpoints", f"epoch_{split}.pt"),
                           weights_only=False)["optimizer"] for m in ("fsdp", "replicated")}
    out["saved"] = {m: {i: {k: v.numpy() for k, v in per.items() if torch.is_tensor(v)}
                        for i, per in sd["state"].items()} for m, sd in saved.items()}
    resumed, step = fresh("fsdp", "fsdp")
    out["resumed_losses"] = [float(step(resumed, b)["loss"]) for b in batches[split:]]
    out["resumed_state"] = {k: v.numpy() for k, v in host_gather(resumed).items()}
    out["shards"] = len(resumed.layout.shards)
    out["generator_resumed"] = bool(torch.equal(resumed.generator.get_state(), generator))
    return out


def task_halo(inp: dict, rank: int) -> dict:
    """The halo route on one giant-graph batch: eval metrics, outputs and one
    train step."""
    from hydragnn_tpu_torch.parallel import halo

    model = _model(inp)
    state = _state(inp, model)
    hb = halo.put_halo_batch(_batch(inp["batch"]), cutoff=inp.get("cutoff"))
    ev = _metrics(halo.make_halo_eval_step(model)(state, hb))
    out = [o.numpy() for o in halo.make_halo_apply(model)(hb)]
    m = _metrics(halo.make_halo_train_step(model)(state, hb))
    from hydragnn_tpu_torch.parallel.halo import halo_boundary_bytes

    return {"eval": ev, "outputs": out, "step": m, "state": _numpy_state(model),
            "node_global": hb.frame.node_global, "n_owned": hb.frame.n_owned,
            "halo_bytes": halo_boundary_bytes(hb.frame.plan, model.spec.hidden_dim)}


def task_refresh(inp: dict, rank: int) -> dict:
    """The halo refresh of ``h[rank]`` and its gradient against ``w[rank]``."""
    from hydragnn_tpu_torch.parallel.halo import make_refresh, put_halo_batch

    hb = put_halo_batch(_batch(inp["batch"]), cutoff=inp["cutoff"])
    h = torch.tensor(inp["h"][rank], requires_grad=True)
    out, _ = make_refresh(hb.send, hb.recv)(h, None)
    (out * torch.tensor(inp["w"][rank])).sum().backward()
    return {"out": out.detach().numpy(), "grad": h.grad.numpy()}


def task_edge(inp: dict, rank: int) -> dict:
    """The edge-sharded route on one batch: outputs, eval metrics and one
    train step."""
    from hydragnn_tpu_torch.parallel import large_graph as lg

    model = _model(inp)
    state = _state(inp, model)
    share = lg.put_large_batch(_batch(inp["batch"]))
    out = [o.numpy() for o in lg.make_edge_sharded_apply(model)(share)]
    ev = _metrics(lg.make_edge_sharded_eval_step(model)(state, share))
    m = _metrics(lg.make_edge_sharded_train_step(model)(state, share))
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return {"outputs": out, "eval": ev, "step": m, "state": _numpy_state(model),
            "grads": grads, "n_edges": int(share.num_edges)}


def task_edge_primitives(inp: dict, rank: int) -> dict:
    """The edge-sharded neighbour sum (``models.common.neighbour_sum`` under
    ``edge_sharded``) over this rank's contiguous half of the edges: as a
    scatter-add of message rows (edge ``e`` reads row ``e``), and inside one
    GIN-style layer; the replicated input's gradient."""
    from types import SimpleNamespace

    from hydragnn_tpu_torch.models.common import edge_sharded, neighbour_sum

    e = inp["snd"].shape[0] // 2
    mine = slice(rank * e, (rank + 1) * e)
    n = inp["h"].shape[0]
    rcv = torch.tensor(inp["rcv"][mine]).long()
    msg = torch.tensor(inp["msg"])
    rows = max(n, msg.shape[0])
    h = torch.tensor(inp["h"], requires_grad=True)
    with edge_sharded(None):
        seg = neighbour_sum(torch.cat([msg, msg.new_zeros(rows - msg.shape[0], msg.shape[1])]),
                            SimpleNamespace(senders=torch.arange(2 * e)[mine], receivers=rcv,
                                            num_nodes=rows, edge_mask=torch.ones(e)))[:n]
        conv = neighbour_sum(h, SimpleNamespace(
            senders=torch.tensor(inp["snd"][mine]).long(), receivers=rcv, num_nodes=n,
            edge_mask=torch.tensor(inp["mask"][mine]))) @ torch.tensor(inp["w"])
    conv.sum().backward()
    return {"segment_sum": seg.numpy(), "conv": conv.detach().numpy(), "dh": h.grad.numpy()}


def task_edge_extremes(inp: dict, rank: int) -> dict:
    """``models.common.edge_segment_extreme`` (max and min) under
    ``edge_sharded`` over this rank's contiguous half of the rows of
    ``data``, and its gradient against the cotangent ``g``: the rows'
    gradients of this rank."""
    from hydragnn_tpu_torch.models.common import edge_segment_extreme, edge_sharded

    e = inp["data"].shape[0] // 2
    mine = slice(rank * e, (rank + 1) * e)
    out = {}
    for kind in ("max", "min"):
        x = torch.tensor(inp["data"][mine], requires_grad=True)
        with edge_sharded(None):
            y = edge_segment_extreme(x, torch.tensor(inp["ids"][mine]), inp["n"], kind)
        (y * torch.tensor(inp["g"])).sum().backward()
        out[kind] = y.detach().numpy()
        out[f"d{kind}"] = x.grad.numpy()
    return out


def task_split_softmax(inp: dict, rank: int) -> dict:
    """``models.common.edge_segment_softmax`` (B3's split form) under
    ``edge_sharded`` over this rank's rows ``inp["rows"][rank]``, and its
    gradient against the cotangent ``g``."""
    from hydragnn_tpu_torch.models.common import edge_segment_softmax, edge_sharded

    mine = inp["rows"][rank]
    x = torch.tensor(inp["logits"][mine], requires_grad=True)
    with edge_sharded(None):
        y = edge_segment_softmax(x, torch.tensor(inp["ids"][mine]), inp["n"])
    (y * torch.tensor(inp["g"][mine])).sum().backward()
    return {"out": y.detach().numpy(), "dx": x.grad.numpy()}


def task_ring(inp: dict, rank: int) -> dict:
    """Ring attention of replicated projections and its gradients against
    the cotangent ``g``."""
    from hydragnn_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v = (torch.tensor(inp[n], requires_grad=True) for n in ("q", "k", "v"))
    out = ring_attention(q, k, v, torch.tensor(inp["bid"]), torch.tensor(inp["mask"]))
    (out * torch.tensor(inp["g"])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def task_store(inp: dict, rank: int) -> dict:
    """A ``ShardedStore`` over this rank's shard with the peers exchanged,
    read whole; its pad spec; the energy regression over this rank's half of
    the samples."""
    from hydragnn_tpu_torch.datasets.sharded import ShardedStore
    from hydragnn_tpu_torch.preprocess.energy_linear_regression import (
        fit_energy_linear_regression)

    path, start, stop = inp["shards"][rank]
    store = ShardedStore(path, start, stop, bind_host=inp["host"], advertise_host=inp["host"])
    try:
        xs = [store[i].x for i in range(store.total)]
        pad = store.pad_spec(4).as_tuple()
        peers = list(store.peers)
    finally:
        store.close()
    samples = torch.load(inp["regression"], weights_only=False)[rank]
    return {"x": xs, "pad": pad, "peers": peers,
            "coeff": fit_energy_linear_regression(samples)}


def task_run_training(inp: dict, rank: int) -> dict:
    """``run_training`` in the group, the flags of ``env`` set; the trained
    parameters, the history and the resilience context's record."""
    from hydragnn_tpu_torch import run_training

    os.environ.update(inp.get("env", {}))
    try:
        history = []
        # a run that reads rank 0's checkpoints back (an elastic one) shares
        # its path, as the ranks of one job share a file system
        path = inp["path"] if inp.get("shared_path") else os.path.join(inp["path"], str(rank))
        state, model, _ = run_training(copy.deepcopy(inp["config"]), samples=inp["samples"],
                                       device="cpu", path=path, history=history)
        res = state.resilience
        ctl = getattr(res, "controller", None)
        return {"state": _numpy_state(model), "history": history,
                "layout": getattr(state.layout, "mode", None), "step": int(state.step),
                "optimizer": {i: {k: v.numpy() for k, v in per.items() if torch.is_tensor(v)}
                              for i, per in state.optimizer.state_dict()["state"].items()},
                "controller": None if ctl is None else {
                    "state": ctl.state, "log": ctl.recovery_log, "recoveries": ctl.recoveries},
                "preempted": bool(getattr(res, "preempted", False)),
                "resume_mode": getattr(res, "resume_mode", None)}
    finally:
        for k in inp.get("env", {}):
            os.environ.pop(k, None)


def task_tp_step(inp: dict, rank: int) -> dict:
    """The tensor-parallel layout over model groups of ``n_model`` ranks:
    the eval step on the data group's batch, then one train step on it;
    the gathered state, the gradients' shapes taken by the shards, and
    the kernels' input widths."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.parallel.mesh import host_gather
    from hydragnn_tpu_torch.parallel.step import (make_parallel_eval_step,
                                                  make_parallel_train_step, shard_state)

    model = _model(inp)
    state = _state(inp, model)
    shard_state(state, inp["opt"], param_mode="tp", n_model=inp["n_model"])
    layout = state.layout
    batch = _batch(inp["batches"][layout.data_index])
    widths = []
    real = fs.gather_scatter_sum

    def spy(h, *a, **k):
        widths.append(int(h.shape[-1]))
        return real(h, *a, **k)

    fs.gather_scatter_sum = spy
    try:
        ev = _metrics(make_parallel_eval_step(model)(state, batch))
        m = _metrics(make_parallel_train_step(model)(state, batch))
    finally:
        fs.gather_scatter_sum = real
    return {"eval": ev, "step": m, "state": {k: v.numpy() for k, v in host_gather(state).items()},
            "shards": [(tuple(s.param.shape), s.dim, tuple(s.shard.shape)) for s in layout.shards],
            "grid": (layout.grid.n_data, layout.grid.n_model, layout.data_index,
                     layout.grid.model_index),
            "widths": widths}


def task_pipeline(inp: dict, rank: int) -> dict:
    """The pipelined eval forward (``norm="running"``) and the one-device
    forward of every microbatch, then ``steps`` pipelined train steps
    (``norm="batch"``) on the same microbatches."""
    from hydragnn_tpu_torch.parallel.mesh import host_gather
    from hydragnn_tpu_torch.parallel.pipeline import (Pipeline, make_pipelined_train_step,
                                                      pipelined_forward, place_pipeline)
    from hydragnn_tpu_torch.train.step import cast_forward

    model = _model(inp)
    state = _state(inp, model)
    place_pipeline(state, inp["opt"])
    batches = [_batch(b) for b in inp["batches"]]
    m = len(batches)
    with torch.no_grad():
        pipe = pipelined_forward(Pipeline(model, m, "running"), batches, train=False)
        seq = [cast_forward(model, b, torch.float32, train=False) for b in batches]
    step = make_pipelined_train_step(model, n_micro=m)
    metrics = [_metrics(step(state, tuple(batches))) for _ in range(inp.get("steps", 1))]
    return {"pipelined": [[o.numpy() for o in p] for p in pipe],
            "sequential": [[o.numpy() for o in p] for p in seq], "steps": metrics,
            "state": {k: v.numpy() for k, v in host_gather(state).items()},
            "blocks": step.pipeline.blocks}


def task_pipeline_layout(inp: dict, rank: int) -> dict:
    """The pipeline's layout: the parameters this stage's optimizer steps,
    ``steps`` pipelined train steps with a checkpoint after the first
    ``save_after``, the gathered state and the checkpoint's (one-device)
    optimizer state; then a fresh state placed, the checkpoint loaded and
    the remaining steps taken again."""
    from hydragnn_tpu_torch.parallel.mesh import host_gather
    from hydragnn_tpu_torch.parallel.pipeline import make_pipelined_train_step, place_pipeline
    from hydragnn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    batches = tuple(_batch(b) for b in inp["batches"])
    names = [n for n, _ in _model(inp).named_parameters()]

    def placed():
        model = _model(inp)
        state = place_pipeline(_state(inp, model), inp["opt"])
        return state, make_pipelined_train_step(model, n_micro=len(batches))

    def opt_numpy(sd):
        return {i: {k: v.numpy() for k, v in per.items() if torch.is_tensor(v)}
                for i, per in sd["state"].items()}

    state, step = placed()
    held = [names[i] for i in state.layout.held]
    for i in range(inp["steps"]):
        if i == inp["save_after"]:
            save_checkpoint(state, "pipe", i, path=inp["path"])
        step(state, batches)
    full = opt_numpy(state.layout.full_optimizer_state(state.optimizer))
    gathered = {k: v.numpy() for k, v in host_gather(state).items()}
    again, step2 = placed()
    load_checkpoint(again, "pipe", path=inp["path"])
    for _ in range(inp["steps"] - inp["save_after"]):
        step2(again, batches)
    return {"held": held, "state": gathered, "optimizer": full,
            "resumed_state": {k: v.numpy() for k, v in host_gather(again).items()},
            "resumed_optimizer": opt_numpy(again.layout.full_optimizer_state(again.optimizer))}


def task_pipeline_refusals(inp: dict, rank: int) -> dict:
    """What the pipeline refuses on this group: the support checks' and a
    step given the wrong number of microbatches."""
    from hydragnn_tpu_torch.parallel.pipeline import (Pipeline, pipelined_forward,
                                                      validate_pipeline_support)

    out = {}
    model = _model(inp)
    try:
        out["k"] = validate_pipeline_support(model, inp["n_stage"])
    except ValueError as e:
        out["k"] = str(e)
    try:
        pipelined_forward(Pipeline(model, inp["n_micro"], "running"),
                          [_batch(b) for b in inp["batches"]], train=False)
        out["micro"] = "ran"
    except ValueError as e:
        out["micro"] = str(e)
    return out


def task_train_loop(inp: dict, rank: int) -> dict:
    """``train_validate_test`` on this rank's slots of the shared loaders
    (``set_group(world, rank)``), K from the config, the data-parallel
    steps; the K = 1 comparison sets the K-block plan itself."""
    from hydragnn_tpu_torch.graphs.batching import GraphLoader
    from hydragnn_tpu_torch.parallel.comm import world_of
    from hydragnn_tpu_torch.parallel.mesh import host_gather
    from hydragnn_tpu_torch.parallel.step import (make_parallel_eval_step,
                                                  make_parallel_train_step, shard_state)
    from hydragnn_tpu_torch.train.loop import train_validate_test

    model = _model(inp)
    state = _state(inp, model)
    shard_state(state, inp["opt"])
    samples = inp["samples"]
    train = GraphLoader(samples["train"], inp["batch_size"], shuffle=True, seed=0,
                        buckets=inp["buckets"])
    loaders = [train] + [GraphLoader(samples[k], inp["batch_size"], drop_last=False,
                                     buckets=train.buckets) for k in ("val", "test")]
    for ld in loaders:
        ld.set_group(world_of(), rank)
    if inp.get("plan_k"):
        train.set_superstep(inp["plan_k"])
    history: list = []
    train_validate_test(state, *loaders, inp["config_nn"], "loop", path=inp["path"],
                        history=history,
                        steps=(make_parallel_train_step(model), make_parallel_eval_step(model)),
                        n_dev=world_of(), route="data")
    return {"state": {k: v.numpy() for k, v in host_gather(state).items()}, "history": history,
            "step": state.step}


TASKS = {name[5:]: fn for name, fn in globals().items() if name.startswith("task_")}


def main() -> None:
    import torch.distributed as dist

    rank, world, port = (int(a) for a in sys.argv[1:4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        for line in sys.stdin:
            req = json.loads(line)
            if req["task"] == "quit":
                break
            try:
                inp = torch.load(req["in"], weights_only=False)
                out = TASKS[req["task"]](inp, rank)
                torch.save(out, f"{req['out']}.{rank}")
                print("DONE", flush=True)
            except Exception:
                print("FAIL " + traceback.format_exc().replace("\n", " | "), flush=True)
    finally:
        if dist.is_initialized():  # an elastic task may have left it
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
