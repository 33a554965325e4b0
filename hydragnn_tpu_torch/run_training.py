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
otherwise every rank trains on its slot of each group of batches
(``parallelism: "data"``), its parameters replicated or, under
``HYDRAGNN_USE_FSDP``, sharded. ``HYDRAGNN_AUTO_PARALLEL=0`` keeps a
process alone unless its caller formed a group. No downgrade: a world above 1 whose group cannot be formed
raises, and so does a failed collective.
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
from .utils import flags, resolve_device

# config switches of the JAX package's run_training that this slice does not
# run: (section, key, whether the value asks for it, what and its slice)
_LATER = (
    ("Training", "population", bool, "population training (a later slice: run-time extras)"),
    ("Training", "resilience", bool, "the resilience layer: non-finite guard, rollback, "
                                     "preemption (a later slice: run-time extras)"),
    ("Architecture", "parallelism", lambda v: str(v or "data").lower() != "data",
     "mesh parallelism beyond data parallel: tensor and pipeline (the next slice: "
     "parallelism)"),
)


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
                                  "ported (the next slice: parallelism)")
    return {"halo": halo, "edge": edge, "fsdp": fsdp}


def _refuse_later_slices(config: dict) -> None:
    nn_cfg = config.get("NeuralNetwork", {})
    for section, key, asks, what in _LATER:
        if asks(nn_cfg.get(section, {}).get(key)):
            raise NotImplementedError(f"{section}.{key}: {what} is not ported yet")
    if config.get("Telemetry"):
        raise NotImplementedError(
            "Telemetry: the telemetry plane is not ported yet (a later slice: run-time extras)"
        )


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
    _refuse_later_slices(config)
    verbosity = int(config.get("Verbosity", {}).get("level", 0))
    grouped = _setup_group(torch.device(device), verbosity)
    device = resolve_device(device)
    world, rank = world_of(), rank_of()
    training_cfg = config.get("NeuralNetwork", {}).get("Training", {})
    if grouped and int(training_cfg.get("steps_per_dispatch", 1) or 1) > 1:
        raise NotImplementedError("Training.steps_per_dispatch > 1 under a process group: "
                                  "supersteps over data-parallel groups are not ported (the "
                                  "next slice: parallelism)")
    arch_cfg = config.get("NeuralNetwork", {}).get("Architecture", {})
    if request["halo"] and not grouped:
        from .parallel.halo import halo_config

        if halo_config(arch_cfg).fallback == "error":
            raise ValueError("Architecture.halo requested but no process group is formed "
                             "(world 1; form one or run under a scheduler)")
    data_route = grouped and not request["halo"] and not request["edge"]
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

    model = create_model_config(config, device=device, seed=seed)
    state = create_train_state(model, training["Optimizer"], seed=seed)
    if training.get("continue"):
        startfrom = training.get("startfrom", log_name)
        meta = load_checkpoint(state, startfrom, path=path)
        if verbosity > 0:
            print(f"resumed from {startfrom} (epoch {meta.get('epoch')})", flush=True)

    route = {}
    if grouped:
        route = _parallel_route(state, config, request, device, seed, verbosity and rank == 0)
        if route.pop("data", False) and not data_route:
            # halo.fallback "data": the loaders take their slots now
            for ld in (train_loader, val_loader, test_loader):
                ld.set_group(world, rank)

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

    train_validate_test(
        state, train_loader, val_loader, test_loader, config["NeuralNetwork"], log_name,
        verbosity, compute_dtype=route.get("dtype", resolve_precision(str(training["precision"]),
                                                                      device)),
        path=path, history=history, steps=route.get("steps"), put=route.get("put"),
        capture=route.get("capture", True), collective=route.get("collective", False),
    )
    # every rank calls it (an FSDP state is gathered); rank 0 writes
    save_checkpoint(state, log_name, epoch=int(training.get("num_epoch", 0)), path=path,
                    meta={"final": True})
    return state, model, config


def _parallel_route(state, config: dict, request: dict, device, seed: int,
                    verbosity: int) -> dict:
    """The steps of this run's parallel route over the default group:
    ``{"steps": (train, eval), "put": ..., "capture": ..., "data": ...}``."""
    from functools import partial

    from .parallel.comm import world_of
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
                    "capture": False, "dtype": dtype}
    elif request["edge"]:
        from .parallel import large_graph as lg

        if verbosity > 0:
            print(f"edge-sharded over {world} ranks", flush=True)
        return {"steps": (lg.make_edge_sharded_train_step(
                              model, dtype, loss_scale=resolve_loss_scale(training)),
                          lg.make_edge_sharded_eval_step(model, dtype)),
                "put": partial(lg.put_large_batch, device=device), "capture": False,
                "dtype": dtype}
    from .parallel.step import (bind_sync_batch_norm, make_parallel_eval_step,
                                make_parallel_train_step, shard_state)

    shard_state(state, training["Optimizer"], param_mode=request["fsdp"], seed=seed)
    bind_sync_batch_norm(model)
    if verbosity > 0:
        print(f"data-parallel over {world} ranks ({request['fsdp']})", flush=True)
    return {"steps": (make_parallel_train_step(model, dtype, resolve_loss_scale(training)),
                      make_parallel_eval_step(model, dtype)),
            "capture": True, "collective": world > 1, "dtype": dtype, "data": True}


__all__ = ["run_training"]
