"""``run_training`` — the training entry point.

Counterpart of ``hydragnn_tpu/run_training.py``: the data prologue (``Dataset.path`` read by ``Dataset.format`` when
no samples are given; a store passed as the samples first takes the
``Dataset.store`` block), the model and its optimizer, optional resume
(``Training.continue`` from the run named by ``Training.startfrom``), the
three loaders behind ``PrefetchLoader``s (``Training.prefetch``, default 2;
``Training.num_workers`` collate threads, default 1), the epoch loop
(``Training.steps_per_dispatch`` train steps per dispatch; on the card
every step a CUDA-graph replay), and a final checkpoint. Runs on the card
unless the caller passes ``device="cpu"``; checkpoints and the augmented
config go under ``path`` (``<path>/<run name>/``).

Parallel runs are one process per GPU (``parallel/``). A run whose world is
above 1 (the scheduler's or torchrun's variables) forms its
``torch.distributed`` group first (``setup_ddp``: NCCL on the card, gloo
with ``device="cpu"``), or trains in the group its caller formed. Under a
group the route follows the config, as in the JAX package:
``Architecture.halo`` (or ``HYDRAGNN_HALO``) partitions one giant graph
over the ranks, ``Architecture.edge_sharding`` splits its edges, and
otherwise ``Architecture.parallelism`` picks the layout: ``"data"`` (every
rank trains on its slot of each group of batches, its parameters replicated
or, under ``HYDRAGNN_USE_FSDP``, sharded), ``"tensor"`` (a ``(data x
model)`` rank grid, ``tensor_parallel_size`` ranks per model group,
``parallel/tensor.py``) or ``"pipeline"`` (a GPipe ring of one stage per
rank over ``pipeline_microbatches`` microbatches, ``parallel/pipeline.py``);
``"tensor"`` and ``"pipeline"`` need more than one rank, as in the JAX
package. ``HYDRAGNN_AUTO_PARALLEL=0`` keeps a process alone unless its
caller formed a group. No downgrade: a world above 1 whose group cannot be
formed raises, and so does a failed collective.

``Training.population.size`` (or ``HYDRAGNN_POPULATION``) above 1 trains a
population instead (``train/population.py``): N members in one captured
step, one process on one device (a process group, a parallel layout or an
interatomic potential is refused), ``population.json`` beside the
checkpoints, and ``Training.continue`` resuming the stacked state from the
checkpoint sidecar's ``population_meta``; it returns ``(PopulationState,
its stacked model, config)``.

The resilience layer (``Training.resilience``, ``HYDRAGNN_FAULT_PLAN``;
``resilience/``) runs through the loop: the non-finite guard, rollback, and
preemption, whose mid-epoch checkpoint a run with ``Training.continue``
resumes exactly (no final checkpoint is written over it);
``resilience.elastic`` (``HYDRAGNN_ELASTIC``) runs the loop inside the
elastic driver, which re-forms a data-parallel group from the survivors of
a lost rank.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .config import get_log_name_config, load_config, save_config, update_config
from .graphs.batching import PrefetchLoader
from .models.create import create_model_config
from .preprocess.load_data import dataset_loading_and_splitting
from .train.checkpoint import load_checkpoint, save_checkpoint
from .train.loop import train_validate_test
from .train.step import create_train_state, resolve_precision
from . import telemetry
from .utils import flags, resolve_device

def _parallel_request(config: dict) -> dict:
    """The JAX package's validation of the parallel switches
    (``hydragnn_tpu/run_training.py:297-340``), before anything is built:
    ``{"halo": bool, "edge": bool, "fsdp": "fsdp" | "replicated"}``."""
    from .parallel.halo import halo_config, halo_enabled

    arch = config.get("NeuralNetwork", {}).get("Architecture", {})
    fsdp = flags.fsdp_mode()  # an unknown HYDRAGNN_FSDP_STRATEGY raises here
    par_mode = str(arch.get("parallelism") or "data").lower()
    if par_mode not in ("data", "tensor", "pipeline"):
        raise ValueError(f"Architecture.parallelism {par_mode!r} not one of 'data', 'tensor', "
                         "'pipeline'")
    halo = halo_enabled(arch)
    if halo:
        halo_config(arch)
        if arch.get("edge_sharding"):
            raise ValueError("Architecture.halo.enabled and Architecture.edge_sharding are "
                             "mutually exclusive large-graph routes; pick one")
        if par_mode != "data":
            raise ValueError("halo partitioning splits the graph over the DATA ranks; "
                             f"Architecture.parallelism={par_mode!r} cannot combine with it")
        if fsdp == "fsdp":
            raise ValueError("halo partitioning keeps the parameters replicated; "
                             "HYDRAGNN_USE_FSDP parameter sharding is not supported with it")
    edge = bool(arch.get("edge_sharding"))
    if edge and str(arch.get("edge_sharding")).lower() in ("full", "nodes"):
        raise NotImplementedError("edge_sharding: 'full' (node fields sharded at rest) is not "
                                  "ported; it comes with the next parallelism slice, beside "
                                  "tensor parallelism of the stacks other than GIN")
    return {"halo": halo, "edge": edge, "fsdp": fsdp, "mode": par_mode}


def _check_run_switches(config: dict) -> None:
    """The population and resilience blocks and the fault plan fail before
    any data is read."""
    from .config.schema import check_population_block

    nn_cfg = config.get("NeuralNetwork", {})
    if "population" in nn_cfg.get("Training", {}):
        check_population_block(nn_cfg["Training"]["population"])
    res_cfg = nn_cfg.get("Training", {}).get("resilience")
    if res_cfg is not None and not isinstance(res_cfg, dict):
        raise ValueError(f"Training.resilience must be a dict, got {type(res_cfg).__name__}")
    from .resilience import FaultPlan

    FaultPlan.from_env()


def _setup_group(device, verbosity: int) -> bool:
    """Whether this run trains in a process group: the caller's, or one
    formed now when the world is above 1 (raising if it cannot be)."""
    from .parallel.comm import live
    from .parallel.distributed import init_comm_size_and_rank, setup_ddp

    if live():
        return True
    if not flags.get(flags.AUTO_PARALLEL):
        return False
    world, _ = init_comm_size_and_rank()
    if world <= 1:
        return False
    setup_ddp(device, verbosity)
    return True


def run_training(config_source, samples: Sequence | None = None, device="cuda",
                 path: str = "./logs/", seed: int = 0, history: list | None = None):
    """Train the configured model on ``samples`` (a list or a store, read
    whole by the data prologue as the JAX package reads it; without them,
    the files of ``Dataset.path``), its parameters and its dropout masks
    drawn from ``seed``. Returns ``(state, model, augmented config)`` as the
    JAX package does; ``state`` holds the model, its optimizer and the step
    count. ``history``, when given, receives one dict per epoch (losses,
    learning rate)."""
    from .parallel.comm import rank_of, world_of

    config = load_config(config_source)
    request = _parallel_request(config)
    _check_run_switches(config)
    verbosity = int(config.get("Verbosity", {}).get("level", 0))
    grouped = _setup_group(torch.device(device), verbosity)
    device = resolve_device(device)
    world, rank = world_of(), rank_of()
    if request["mode"] != "data" and world <= 1:
        # hydragnn_tpu/run_training.py:415-423: no downgrade to one device
        raise ValueError(f"Architecture.parallelism={request['mode']!r} requested but no "
                         f"multi-rank process group is formed ({world} rank(s))")
    arch_cfg = config.get("NeuralNetwork", {}).get("Architecture", {})
    if request["halo"] and not grouped:
        from .parallel.halo import halo_config

        if halo_config(arch_cfg).fallback == "error":
            raise ValueError("Architecture.halo requested but no process group is formed "
                             "(world 1; form one or run under a scheduler)")
    data_route = (grouped and not request["halo"] and not request["edge"]
                  and request["mode"] == "data")
    # a ShardedStore passed as the samples takes the Dataset.store block
    # (replication, peer timeout, quarantine and probe cadence) before any
    # loader touches the network
    store_cfg = config.get("Dataset", {}).get("store")
    if store_cfg and hasattr(samples, "apply_config"):
        samples.apply_config(store_cfg)
    train_loader, val_loader, test_loader = dataset_loading_and_splitting(
        config, samples=samples, rank=rank if data_route else 0,
        world=world if data_route else 1)
    config = update_config(config, train_loader.samples, val_loader.samples,
                           test_loader.samples)
    training = config["NeuralNetwork"]["Training"]
    log_name = get_log_name_config(config)
    if rank == 0:
        save_config(config, log_name, path)

    # the telemetry plane: the validated Telemetry block (env flags folded
    # in) arms the registry, journal and trace process-wide; rank 0's
    # journal opens next to the run's checkpoints, so every subsystem's
    # records land in one events.jsonl
    tel_cfg = telemetry.configure(config)
    if tel_cfg.enabled and tel_cfg.journal and rank == 0:
        telemetry.open_journal(log_name, path=path)
        telemetry.emit("run_start", log_name=log_name, world=world)
    # try/finally: a crashed run still records run_end, saves trace.json
    # and closes the journal (the post-mortem CLI's whole point)
    try:
        return _train(config, training, log_name, path, device, seed, verbosity, grouped,
                      request, world, rank, (train_loader, val_loader, test_loader), history)
    finally:
        _finish_telemetry(tel_cfg, log_name, path, rank, verbosity)


def _finish_telemetry(tel_cfg, log_name: str, path: str, rank: int, verbosity: int) -> None:
    """``run_end``, then on rank 0 ``trace.json`` (with trace events on)
    and ``ledger.json`` (the captured graphs' costs; a path-valued
    ``HYDRAGNN_LEDGER`` redirects it) next to the journal, which closes."""
    import os

    from .utils import tracer

    telemetry.emit("run_end", log_name=log_name)
    tracer.stop_profiler()
    if rank == 0:
        run_dir = os.path.join(path, log_name)
        try:
            if tel_cfg.enabled and tel_cfg.trace_events:
                telemetry.save_trace(os.path.join(run_dir, "trace.json"))
            telemetry.ledger.maybe_save(os.path.join(run_dir, "ledger.json"))
        except OSError as e:
            if verbosity > 0:
                print(f"telemetry save failed: {e}", flush=True)
        if verbosity > 0:
            tracer.print_timers(verbosity)
    telemetry.close_journal()


def _train(config: dict, training: dict, log_name: str, path: str, device, seed: int,
           verbosity: int, grouped: bool, request: dict, world: int, rank: int, loaders,
           history):
    """The model, its optimizer and the epoch loop of :func:`run_training`
    (after the data prologue); returns ``(state, model, config)``."""
    from .parallel.comm import rank_of

    from .train.population import resolve_population_size

    if resolve_population_size(training) > 1:
        return _train_population(config, training, log_name, path, device, seed, verbosity,
                                 grouped, request, world, loaders)
    train_loader, val_loader, test_loader = loaders
    model = create_model_config(config, device=device, seed=seed)
    state = create_train_state(model, training["Optimizer"], seed=seed)
    resume_meta = None
    if training.get("continue"):
        startfrom = training.get("startfrom", log_name)
        meta = load_checkpoint(state, startfrom, path=path)
        if meta.get("mid_epoch"):
            # a preemption checkpoint: the loop resumes at its sidecar's
            # position
            resume_meta = meta
        if verbosity > 0:
            print(f"resumed from {startfrom} (epoch {meta.get('epoch')}"
                  + (f", {meta.get('raw_batches_done')} batches already trained"
                     if resume_meta else "") + ")", flush=True)

    route = {}
    if grouped:
        route = _parallel_route(state, config, request, device, seed, verbosity and rank == 0)
        _group_loaders(route, (train_loader, val_loader, test_loader))

    depth = int(training.get("prefetch", 2))
    workers = int(training.get("num_workers", 1) or 1)
    if depth > 0:
        # a large-graph route's put partitions each batch on the host
        to = None if route.get("put") is not None else device
        train_loader, val_loader, test_loader = (
            PrefetchLoader(ld, depth=depth, device=to, workers=workers)
            for ld in (train_loader, val_loader, test_loader))
    if config.get("Visualization", {}).get("create_plots"):
        print("Visualization.create_plots: plots are not ported yet (a later slice: run-time "
              "extras; they draw with matplotlib, which the port does not require); training "
              "without them", flush=True)

    from .resilience import Resilience

    from .utils.walltime import make_walltime_check

    res = Resilience.from_config(training, device)
    state.resilience = res
    loaders = (train_loader, val_loader, test_loader)
    # on SLURM, stop before the scheduler kills the job (reference
    # distributed.py:614-639)
    walltime_check = make_walltime_check()

    def run_segment(resume):
        return train_validate_test(
            state, *loaders, config["NeuralNetwork"], log_name, verbosity,
            compute_dtype=route.get("dtype", resolve_precision(str(training["precision"]),
                                                               device)),
            path=path, history=history, steps=route.get("steps"), put=route.get("put"),
            capture=route.get("capture", True), collective=route.get("collective", False),
            resilience=res, resume_meta=resume, per_step=route.get("per_step", 1),
            n_dev=route.get("n_dev", 1), route=route.get("route", "single"),
            logical_step=route.get("logical_step"), walltime_check=walltime_check)

    if res.elastic:
        from .resilience import train_elastic

        def reform(survivors, generation, mode):
            """Restore the mid-epoch checkpoint: in place when no rank was
            lost; else leave the group and, on a survivor, form the new one
            and re-place the state on it."""
            from .parallel.distributed import reform_group
            from .train.optimizer import select_optimizer

            if mode == "resume":
                return load_checkpoint(state, log_name, path=path)
            if reform_group(survivors, generation, device) is None:
                return None
            state.layout = None
            state.optimizer = select_optimizer(training["Optimizer"], model.parameters())
            meta = load_checkpoint(state, log_name, path=path)
            route.clear()
            route.update(_parallel_route(state, config, request, device, seed,
                                         verbosity and rank_of() == 0))
            _group_loaders(route, loaders)
            return meta

        _, ctl = train_elastic(run_segment, reform, res, route=route.get("route", "single"),
                               world=world, log=lambda m: verbosity > 0 and rank_of() == 0
                               and print(m, flush=True))
        if ctl.state == "lost":
            return state, model, config
    else:
        run_segment(resume_meta)
    if res.preempted:
        # the mid-epoch checkpoint stays the one "latest" names
        return state, model, config
    # every rank calls it (an FSDP state is gathered); rank 0 writes
    save_checkpoint(state, log_name, epoch=int(training.get("num_epoch", 0)), path=path,
                    meta={"final": True})
    return state, model, config


def _train_population(config: dict, training: dict, log_name: str, path: str, device,
                      seed: int, verbosity: int, grouped: bool, request: dict, world: int,
                      loaders):
    """The population route of :func:`run_training`
    (``hydragnn_tpu/run_training.py:121-256``): refusals, the continue
    resume, the prefetching loaders, :func:`train_population` and the final
    save; returns ``(pstate, pstate.model, config)``."""
    from .train.population import (population_meta, population_template,
                                   resolve_population_size, train_population)
    from .utils.walltime import make_walltime_check

    n = resolve_population_size(training)
    if request["mode"] != "data" or request["edge"] or request["halo"]:
        raise ValueError(f"Training.population.size={n} cannot combine with "
                         f"Architecture.parallelism={request['mode']!r}/edge_sharding/halo: the "
                         "population's member axis is the step's parallelism")
    if grouped or world > 1:
        raise ValueError(f"Training.population.size={n} trains in one process, but this job "
                         f"runs {world} ranks: launch one process, or run the trials as "
                         "subprocesses")
    if config["NeuralNetwork"]["Architecture"].get("enable_interatomic_potential"):
        raise ValueError(f"Training.population.size={n}: interatomic potentials (forces from "
                         "the position gradient) have no population step")
    train_loader, val_loader, test_loader = loaders
    resume = None  # (PopulationState, start epoch, tracker state)
    if training.get("continue"):
        from .train.checkpoint import load_checkpoint

        startfrom = training.get("startfrom", log_name)
        template = population_template(config, n, device=device)
        meta = load_checkpoint(template, startfrom, path=path)
        saved_n = int(meta.get("population", 0) or 0)
        if saved_n and saved_n != n:
            raise ValueError(f"the checkpoint of {startfrom} holds a {saved_n}-member "
                             f"population but the config asks for {n}")
        resume = (template, int(meta.get("population_epochs_done", meta.get("epoch", 0))),
                  meta.get("member_tracker"))
        if verbosity > 0:
            print(f"resumed a {n}-member population from {startfrom} ({resume[1]} epoch(s) "
                  "already trained)", flush=True)
    depth = int(training.get("prefetch", 2))
    workers = int(training.get("num_workers", 1) or 1)
    if depth > 0:
        train_loader, val_loader, test_loader = (
            PrefetchLoader(ld, depth=depth, device=device, workers=workers)
            for ld in (train_loader, val_loader, test_loader))
    pstate, summary = train_population(
        config, train_loader, val_loader, test_loader, log_name, verbosity,
        walltime_check=make_walltime_check(),
        initial_state=None if resume is None else resume[0],
        start_epoch=0 if resume is None else resume[1],
        tracker_state=None if resume is None else resume[2], path=path, device=device,
        seed=seed)
    # epochs trained = the resume point + this run's epochs (the walltime
    # guard may have stopped early: a later continue trains the rest)
    epochs_done = int(summary.get("start_epoch", 0)) + len(summary.get("history", []))
    meta = {"final": True, **population_meta(n, epochs_done),
            "member_tracker": summary.get("member_tracker"),
            "member_status": [m["status"] for m in summary["members"]]}
    save_checkpoint(pstate, log_name, epoch=epochs_done, path=path, meta=meta)
    return pstate, pstate.model, config


def _group_loaders(route: dict, loaders) -> None:
    """The loaders' share of every group of batches, as the route asks
    (``route["loader_group"]``: ``(n, slot, slots)``)."""
    spec = route.pop("loader_group", None)
    if spec is None:
        return
    n, slot, slots = spec
    for ld in loaders:
        ld.set_group(n, slot, slots)


def _parallel_route(state, config: dict, request: dict, device, seed: int,
                    verbosity: int) -> dict:
    """The steps of this run's parallel route over the default group:
    ``{"steps": (train, eval), "put": ..., "capture": ..., "data": ...}``."""
    from functools import partial

    from .parallel.comm import rank_of, world_of
    from .train.step import resolve_loss_scale

    nn_cfg = config["NeuralNetwork"]
    training, arch = nn_cfg["Training"], nn_cfg.get("Architecture", {})
    model = state.model
    dtype = resolve_precision(str(training["precision"]), device)
    world = world_of()
    if request["halo"]:
        from .parallel import halo

        cfg = halo.halo_config(arch)
        try:
            halo.validate_halo_support(model.spec)
        except ValueError as e:
            if cfg.fallback != "data":
                raise
            if verbosity > 0:
                print(f"halo partitioning falling back to data parallel: {e}", flush=True)
        else:
            if verbosity > 0:
                print(f"halo partitioning over {world} ranks", flush=True)
            if resolve_loss_scale(training) is not None and verbosity > 0:
                print("Training.loss_scale is not wired into the halo train step; this mode "
                      "trains UNSCALED", flush=True)
            return {"steps": (halo.make_halo_train_step(model, dtype),
                              halo.make_halo_eval_step(model, dtype)),
                    "put": partial(halo.put_halo_batch, cfg=cfg, cutoff=arch.get("radius"),
                                   device=device),
                    "capture": False, "dtype": dtype, "route": "halo"}
    elif request["edge"]:
        from .parallel import large_graph as lg

        if verbosity > 0:
            print(f"edge-sharded over {world} ranks", flush=True)
        return {"steps": (lg.make_edge_sharded_train_step(
                              model, dtype, loss_scale=resolve_loss_scale(training)),
                          lg.make_edge_sharded_eval_step(model, dtype)),
                "put": partial(lg.put_large_batch, device=device), "capture": False,
                "dtype": dtype, "route": "edge"}
    if request["mode"] == "pipeline":
        from .parallel.pipeline import (make_pipelined_eval_step, make_pipelined_train_step,
                                        place_pipeline)

        n_micro = int(arch.get("pipeline_microbatches") or world)
        train_step = make_pipelined_train_step(model, dtype, n_micro,
                                               loss_scale=resolve_loss_scale(training))
        place_pipeline(state, training["Optimizer"])
        if verbosity > 0:
            print(f"pipeline-parallel: {world}-stage GPipe ring, {n_micro} microbatches",
                  flush=True)
        return {"steps": (train_step, make_pipelined_eval_step(model, dtype, n_micro)),
                "capture": False, "dtype": dtype, "per_step": n_micro, "n_dev": n_micro,
                "route": "pipeline", "loader_group": (n_micro, None, tuple(range(n_micro)))}
    from .parallel.step import (bind_sync_batch_norm, make_parallel_eval_step,
                                make_parallel_train_step, shard_state)

    if request["mode"] == "tensor":
        from .parallel.tensor import default_tensor_parallel_size

        tp = default_tensor_parallel_size(world, arch)
        if world % tp:
            raise ValueError(f"tensor_parallel_size={tp} does not divide the {world} ranks")
        shard_state(state, training["Optimizer"], param_mode="tp", n_model=tp, seed=seed)
        grid = state.layout.grid
        bind_sync_batch_norm(model, grid.data_group)
        if verbosity > 0:
            print(f"tensor-parallel: ({grid.n_data} data x {tp} model) rank grid", flush=True)
        return {"steps": (make_parallel_train_step(model, dtype, resolve_loss_scale(training)),
                          make_parallel_eval_step(model, dtype)),
                "capture": False, "dtype": dtype, "n_dev": grid.n_data, "route": "tensor",
                "loader_group": ((grid.n_data, grid.data_index, None) if grid.n_data > 1
                                 else None)}
    shard_state(state, training["Optimizer"], param_mode=request["fsdp"], seed=seed)
    bind_sync_batch_norm(model)
    if verbosity > 0:
        print(f"data-parallel over {world} ranks ({request['fsdp']})", flush=True)
    train_step = make_parallel_train_step(model, dtype, resolve_loss_scale(training))
    return {"steps": (train_step, make_parallel_eval_step(model, dtype)),
            "capture": True, "collective": world > 1, "dtype": dtype, "n_dev": world,
            "route": "data", "logical_step": train_step,
            # the loaders take their slots here when they did not at their
            # making (halo.fallback "data", a re-formed group)
            "loader_group": (world, rank_of(), None) if world > 1 else None}


__all__ = ["run_training"]
