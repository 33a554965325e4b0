"""The epoch loop: train, validate, test, with the resilience layer.

Counterpart of ``hydragnn_tpu/train/loop.py``, with the plain or, for
interatomic potentials, the MLIP train and eval steps: per epoch the train
loader reshuffles (``set_epoch``), the train metrics are reduced weighted by
graph count, the validation and test splits are evaluated, the plateau
scheduler steps on the validation loss, then the best-model checkpoint and
early stopping run. A split's per-head RMSE is one square root of its summed
squared errors.

On the card every step is a replay of a CUDA graph (``capture.py``): the
train step and the eval step per bucket. With
``Training.steps_per_dispatch`` = K > 1 the loader plans the epoch
bucket-major, in blocks of K (``train/superstep.py``), and a block is the
loop's unit of dispatch. On the CPU the same loop runs the eager steps.

The step metrics stay on the device until the epoch ends and come to the
host in one transfer. ``run_training`` hands the loop the parallel layouts'
steps (``parallel/``): the data-parallel steps replay their CUDA graphs as
the one-device steps do; the tensor-parallel, pipelined, halo and
edge-sharded steps run eager. ``per_step`` > 1 hands a step a tuple of
consecutive batches (the pipeline's microbatches, an elastic survivor's
share of the saved update grid); ``put`` turns each collated batch into the
route's input. Under a process group only rank 0 logs; every rank takes the
checkpoint decisions (on the ranks' summed losses) and calls
``save_checkpoint``, and rank 0 writes.

The resilience layer (``resilience/``, ``Training.resilience``) is
threaded through every epoch, as in the JAX loop (``:268-380,
486-610``): the non-finite guard wraps the train step before its capture;
the host reads the skips behind an in-flight window and a streak rolls the
state back to the last good checkpoint with a cut learning rate (written
into the captured step's device rate), up to ``max_rollbacks``; a stop
request (SIGTERM, the elastic controller), agreed by the ranks at a
dispatch boundary, saves a mid-epoch checkpoint whose sidecar lets a fresh
process resume on exactly the batches not yet trained; chaos faults fire
at their (epoch, dispatch); the watchdog brackets the blocking reads.

The telemetry plane (``telemetry/``) runs through it as through the JAX
loop: host-clock spans (``train``, ``dataload``, ``validate``, ``test``,
and the superstep's ``stage_block``), the journal's ``epoch`` record per
epoch (``dispatch_block`` per block at K > 1), ``rollback``,
``preempt_checkpoint``, the capture sentinel
(``HYDRAGNN_COMPILE_SENTINEL``, ``analysis/sentinel.py``), a
``torch.profiler`` trace of the first epoch at ``HYDRAGNN_TRACE_LEVEL`` >=
1, and the one-shot ledger probe of an eager route. Nothing of it reads a
tensor inside the dispatch loop: the records take the host's counts and
the epoch's metrics after their one transfer. The compile cache is not
in this slice.

A population (``train/population.py``) runs through :func:`train_epoch` and
:func:`evaluate` with its own ``accumulate`` (the member axis kept) and
resilience hooks (per-member skip tracking that never rolls back).
"""

from __future__ import annotations

import itertools
import os
import time
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import torch

from .. import telemetry as tel
from ..capture import Dispatch
from ..utils import flags
from ..utils import tracer as tr
from .checkpoint import Checkpoint, EarlyStopping, load_checkpoint, save_checkpoint
from .optimizer import ReduceLROnPlateau, get_learning_rate, set_learning_rate
from .step import TrainState, make_eval_step, make_train_step, resolve_loss_scale
from .superstep import make_superstep, resolve_steps_per_dispatch

# dispatches the host runs ahead of the skip metrics it reads (the JAX
# loop's in-flight window)
MAX_IN_FLIGHT = 32


def _log(verbosity: int, msg: str) -> None:
    if verbosity > 0:
        print(msg, flush=True)


def accumulate(step_metrics: list[dict], extra_keys: tuple = ()):
    """Graph-count-weighted means of an epoch's ``loss`` and ``tasks_loss``
    and the sums of ``extra_keys``, after one device-to-host transfer."""
    if not step_metrics:
        return 0.0, np.zeros(0), {k: None for k in extra_keys}
    keys = ("num_graphs", "loss", "tasks_loss") + tuple(extra_keys)
    host = {k: torch.stack([m[k] for m in step_metrics]).double().cpu().numpy() for k in keys}
    g = host["num_graphs"]
    denom = max(float(g.sum()), 1.0)
    loss = float((host["loss"] * g).sum()) / denom
    tasks = (host["tasks_loss"] * g[:, None]).sum(axis=0) / denom
    return loss, tasks, {k: host[k].sum(axis=0) for k in extra_keys}


_accumulate = accumulate  # the default reduction, where a parameter shadows the name


def _chunks(iterable, n: int):
    """Consecutive ``n``-tuples of ``iterable`` (the last one may be
    shorter)."""
    it = iter(iterable)
    while True:
        chunk = tuple(itertools.islice(it, n))
        if not chunk:
            return
        yield chunk


def _batches(loader, device, put=None, per_step: int = 1):
    def one(batch):
        if put is not None:
            return put(batch)
        return batch if batch.device == device else batch.to(device)

    moved = (one(b) for b in loader)
    return _chunks(moved, per_step) if per_step > 1 else moved


def _step_of(superstep):
    """The per-step callable of a ``Superstep`` (its dispatch), or the step
    itself."""
    return getattr(superstep, "dispatch", superstep)


def train_epoch(superstep, state: TrainState, loader, put=None, resilience=None,
                per_step: int = 1, n_dev: int = 1, accumulate=None):
    """One epoch of train steps (the loader plans the blocks); returns
    (mean loss, per-task mean losses). ``superstep``: a ``Superstep`` (its
    ``k`` steps per dispatch) or a ``(state, batch) -> metrics`` step.
    ``put`` turns each batch into the step's input (a parallel route's share
    of it); ``per_step`` consecutive batches go to one step as a tuple.
    ``resilience`` (a ``Resilience``) polls stop requests and fires chaos
    faults at dispatch boundaries, tracks the guard's skips and records the
    progress (``interrupted``, ``epoch_raw_done``: ``n_dev`` raw batches per
    step); a guarded step's skips come back off ``state.step`` here, and an
    epoch whose every step was skipped reports a NaN loss. ``accumulate``
    replaces the epoch's reduction (a population's, whose metrics carry the
    member axis) and then owns the skip reporting: the host step count and
    the all-skipped NaN are the one state's."""
    device = next(state.model.parameters()).device
    step = _step_of(superstep)
    k = max(1, int(getattr(superstep, "k", 1)))
    res = resilience
    wd = res.watchdog_guard if res is not None else (lambda what: nullcontext())
    dwd = getattr(res, "dispatch_watchdog", None)
    chaos = res.chaos if res is not None else None
    tracker = res.new_tracker(MAX_IN_FLIGHT) if res is not None else None
    epoch_no = res.current_epoch if res is not None else 0
    interrupted, dispatches, metrics = False, 0, []
    # host-clock spans: each batch's wait in "dataload", each block's
    # staging (K batches) in the superstep's "stage_block"
    blocks = _chunks(tr.timed_iter(_batches(loader, device, put, per_step)), k)
    if k > 1:
        blocks = tr.timed_iter(blocks, "stage_block")
    tr.start("train")
    try:
        for ib, block in enumerate(blocks):
            if res is not None and res.stop_requested(ib):
                interrupted = True
                break
            # a segment's first dispatch captures its graphs: no deadline
            guard = (dwd.guard(f"dispatch {ib}", on_expire=res.note_hung_dispatch)
                     if dwd is not None and ib > 0 else nullcontext())
            with guard:
                if chaos is not None:
                    block = chaos.on_dispatch(epoch_no, ib, list(block))
                for b in block:
                    m = step(state, b)
                    metrics.append(m)
                    if tracker is not None and "skipped" in m:
                        with wd("skip read (in-flight window)"):
                            tracker.push(m["skipped"])
            dispatches += 1
            if k > 1:
                # one record per block (the unit of dispatch); K = 1 epochs
                # summarize in the epoch record
                tel.emit("dispatch_block", block=ib, step=ib * k * n_dev, k=k, n_dev=n_dev)
        if res is not None:
            res.interrupted = interrupted
            res.epoch_raw_done = dispatches * k * n_dev
        if tracker is not None:
            with wd("epoch-end skip drain"):
                tracker.finish()  # may raise DivergenceDetected
        has_skip = bool(metrics) and "skipped" in metrics[0]
        # the one transfer waits for the last step: inside the train span
        with wd("epoch-end metrics transfer"):
            loss, tasks, extras = (accumulate or _accumulate)(
                metrics, ("skipped", "num_graphs") if has_skip else ())
    finally:
        tr.stop("train")
    if has_skip:
        n_skipped = int(extras["skipped"].sum())
        if res is not None:
            res.skipped_total += n_skipped
        if accumulate is not None:
            return loss, tasks
        state.step -= n_skipped  # a skipped step reverts its count
        if n_skipped and float(extras["num_graphs"].sum()) == 0.0:
            # nothing trained: 0.0 is not a loss, and NaN never beats one
            loss, tasks = float("nan"), np.full_like(np.asarray(tasks, np.float64), np.nan)
    return loss, tasks


def evaluate(eval_step, state: TrainState, loader, put=None, per_step: int = 1,
             span: str = "validate", accumulate=None):
    """A whole split through ``eval_step`` (``(state, batch) -> metrics``:
    on the card the eval ``Dispatch``), in a ``span`` host span; returns
    (loss, per-task losses, per-head RMSE). ``accumulate``: a population's
    reduction, every return value then per member."""
    device = next(state.model.parameters()).device
    with tr.span(span):
        metrics = [eval_step(state, batch) for batch in _batches(loader, device, put, per_step)]
        loss, tasks, extras = (accumulate or _accumulate)(
            metrics, extra_keys=("head_sse", "head_count"))
    sse, count = extras["head_sse"], extras["head_count"]
    rmse = np.sqrt(sse / np.maximum(count, 1.0)) if sse is not None else np.zeros(0)
    return loss, tasks, rmse


def test(eval_step, state: TrainState, loader):
    """(total error, per-task losses, per-head RMSE) of the test split."""
    return evaluate(eval_step, state, loader, span="test")


def _eager(train_step, k: int = 1):
    """The eager steps as the loop dispatches them: ``k`` steps per
    dispatch."""
    return SimpleNamespace(k=k, dispatch=train_step)


def _raw_len(loader) -> int:
    return loader.raw_len() if hasattr(loader, "raw_len") else len(loader)


def _finite_or_none(x):
    return float(x) if x is not None and np.isfinite(x) else None


def preempt_meta(epoch: int, raw_done: int, k: int, n_dev: int, train_loader, scheduler,
                 checkpoint, early_stopping) -> dict:
    """The sidecar of a preemption checkpoint: what a resumed process needs
    to train exactly the batches not yet seen and to keep the host-side
    schedule and early-stop records (the JAX loop's ``_preempt_meta``)."""
    meta = {"mid_epoch": True, "epoch": int(epoch), "raw_batches_done": int(raw_done),
            "steps_per_dispatch": int(k), "n_dev": int(n_dev),
            "shuffle_seed": int(getattr(train_loader, "seed", 0) or 0), "preempted": True,
            "scheduler": scheduler.state_dict()}
    if checkpoint is not None:
        meta["best_val"] = _finite_or_none(checkpoint.best)
    if early_stopping is not None:
        meta["early_stop"] = {"best": _finite_or_none(early_stopping.best),
                              "count": int(early_stopping.count)}
    return meta


def reshard_resume_reason(saved_k: int, k: int, route: str) -> str | None:
    """Why a mid-epoch resume onto another group width cannot finish the
    epoch on the saved update grid, or None when it can (the JAX loop's
    ``_reshard_resume_reason``): K and the logical grid fix the batch order,
    so a data-parallel route that can take several batches per rank and
    step finishes the saved grid exactly."""
    if saved_k != k:
        return ("steps_per_dispatch changed: the block plan orders the epoch by the K x n_dev "
                "grid, so the saved position names another batch stream")
    if route != "data":
        return f"the {route} route has no resharded equivalent of the saved update grid"
    return None


def _rollback_state(state: TrainState, log_name: str, path: str, res, rollbacks: int, err,
                    verbosity: int) -> None:
    """Divergence escalation: restore the last good checkpoint into the live
    state (in place: the captured graphs keep their tensors) with the
    learning rate cut by ``factor ** rollbacks``, or raise
    ``TrainingDivergedError`` past ``max_rollbacks`` consecutive rollbacks
    or with nothing to restore. Consecutive rollbacks restore the same
    checkpoint, so the compounding cut makes each retry another
    trajectory."""
    from ..resilience import TrainingDivergedError

    if rollbacks > res.max_rollbacks:
        raise TrainingDivergedError(
            f"training diverged: {err}. Rolled back {rollbacks - 1} consecutive time(s) with "
            f"compounding LR cuts (factor {res.rollback_lr_factor}) and the run still makes "
            "non-finite steps; aborting. Likely causes: a learning rate too high for this "
            "precision, corrupt input samples, a numerically unstable loss term.")
    try:
        meta = load_checkpoint(state, log_name, path=path)
    except FileNotFoundError as e:
        raise TrainingDivergedError(
            f"training diverged ({err}) and no checkpoint exists to roll back to; enable "
            "Training.Checkpoint or Training.resilience.checkpoint_every_epoch: {e}") from e
    old_lr = get_learning_rate(state.optimizer)
    new_lr = old_lr * res.rollback_lr_factor ** rollbacks
    set_learning_rate(state.optimizer, new_lr)
    tel.emit("rollback", restored_epoch=meta.get("epoch"), consecutive=rollbacks,
             lr_old=float(old_lr), lr_new=float(new_lr), cause=str(err)[:256])
    tel.counter("divergence_rollbacks_total").inc()
    _log(verbosity, f"divergence rollback #{rollbacks}: restored the checkpoint of epoch "
                    f"{meta.get('epoch')}, LR {old_lr:.2e} -> {new_lr:.2e}")


def train_validate_test(state: TrainState, train_loader, val_loader, test_loader,
                        config_nn: dict, log_name: str, verbosity: int = 0,
                        compute_dtype: torch.dtype = torch.float32, path: str = "./logs/",
                        start_epoch: int = 0, history: list | None = None,
                        steps=None, put=None, capture: bool = True,
                        collective: bool = False, resilience=None, resume_meta=None,
                        per_step: int = 1, n_dev: int = 1, route: str = "single",
                        walltime_check=None, logical_step=None) -> TrainState:
    """The epoch loop over epochs ``start_epoch .. Training.num_epoch - 1``
    (a resumed run passes the first epoch it has not trained; the plateau
    schedule and the best-model and early-stopping records start afresh,
    unless ``resume_meta`` restores them). ``history``, when given,
    receives one dict per epoch (train/val/test losses, LR, and the epoch's
    wall seconds up to the checkpoint). ``steps``: the ``(train_step,
    eval_step)`` of a parallel route in place of the one-device steps;
    ``put``: each batch to the route's input; ``capture=False``: the steps
    run eager on the card too; ``collective``: the steps' graphs are
    captured on every rank of a process group alike
    (``capture.Dispatch``); ``per_step``: batches per step (a tuple);
    ``n_dev``: raw batches one step of this rank stands for (the logical
    group width the sidecar records); ``route``: the layout's name (its
    elastic and resume policy). ``resilience`` (default: built from
    ``Training.resilience``) and ``resume_meta`` (a preemption checkpoint's
    sidecar: resume exactly where it stopped); ``logical_step``: the
    route's train step over a tuple of batches, for finishing an
    interrupted epoch on a wider saved grid. ``walltime_check()`` True
    stops after the epoch."""
    from ..parallel.comm import rank_of
    from ..resilience import DivergenceDetected, Resilience, wrap_step_with_guard

    training = config_nn["Training"]
    num_epoch = int(training["num_epoch"])
    main = rank_of() == 0
    verbosity = verbosity if main else 0
    device = next(state.model.parameters()).device
    res = resilience if resilience is not None else Resilience.from_config(training, device)
    k = resolve_steps_per_dispatch(training)
    if k > 1 and (put is not None or per_step > 1):
        _log(verbosity, f"supersteps requested (K={k}) but a per-batch placement or a "
                        "microbatched route is active: pinning K=1")
        k = 1
    if k > 1:
        train_loader.set_superstep(k)
    if steps is not None:
        train_step, eval_step = steps
    elif state.model.spec.enable_interatomic_potential:
        # energy + per-atom energy + force loss, forces from the position
        # gradient
        from ..models.mlip import make_mlip_eval_step, make_mlip_train_step

        train_step = make_mlip_train_step(state.model, compute_dtype,
                                          resolve_loss_scale(training))
        eval_step = make_mlip_eval_step(state.model, compute_dtype)
    else:
        train_step = make_train_step(compute_dtype, resolve_loss_scale(training))
        eval_step = make_eval_step(compute_dtype)
    if res.guard_enabled:
        train_step = wrap_step_with_guard(train_step)
        if logical_step is not None:
            logical_step = wrap_step_with_guard(logical_step)
    precision = str(compute_dtype)
    if capture:
        superstep = make_superstep(train_step, k, collective, ledger={
            "model": log_name, "kind": "train_step", "precision": precision})
        eval_step = Dispatch(eval_step, "eval", collective=collective, ledger={
            "model": log_name, "kind": "eval_step", "precision": precision})
    else:
        superstep = _eager(train_step, k)
    if not (capture and device.type == "cuda"):
        # an eager route captures nothing: the one-shot probe counts its
        # first train step instead (HYDRAGNN_LEDGER naming a path arms it)
        superstep = _ledger_probe(superstep, log_name, precision)
    scheduler = ReduceLROnPlateau(get_learning_rate(state.optimizer))
    checkpoint = (
        Checkpoint(log_name, warmup=int(training.get("checkpoint_warmup", 0)), path=path)
        if training.get("Checkpoint", False) else None
    )
    early_stopping = (
        EarlyStopping(patience=int(training.get("patience", 10)))
        if training.get("EarlyStopping", False) else None
    )
    # a dataset too small (or perc_train = 1) can leave val/test empty
    skip_valtest = len(val_loader.samples) == 0 or len(test_loader.samples) == 0

    resume_skip, resume_group = 0, None
    res.resume_mode = res.resume_reason = None
    if resume_meta and resume_meta.get("mid_epoch"):
        start_epoch = int(resume_meta.get("epoch", 0))
        resume_skip = int(resume_meta.get("raw_batches_done", 0))
        saved_k = int(resume_meta.get("steps_per_dispatch", 1))
        saved_ndev = int(resume_meta.get("n_dev", 1))
        if resume_skip and (saved_k, saved_ndev) != (k, n_dev):
            reason = reshard_resume_reason(saved_k, k, route)
            if reason is None and logical_step is not None:
                resume_group = saved_ndev
                res.resume_mode = "elastic"
                _log(verbosity, f"mid-epoch resume: the group width changed ({saved_ndev} -> "
                                f"{n_dev}); finishing the interrupted epoch on the saved "
                                f"{saved_ndev}-batch update grid")
            else:
                res.resume_mode = "restart"
                res.resume_reason = reason or "the route takes one batch per rank and step"
                _log(verbosity, f"mid-epoch resume: the dispatch layout changed ({saved_k}x"
                                f"{saved_ndev} -> {k}x{n_dev}) and an exact resume is not "
                                f"possible ({res.resume_reason}); restarting the interrupted "
                                "epoch from its first batch")
                resume_skip = 0
        ckpt_seed = resume_meta.get("shuffle_seed")
        live_seed = int(getattr(train_loader, "seed", 0) or 0)
        if resume_skip and ckpt_seed is not None and int(ckpt_seed) != live_seed:
            _log(verbosity, f"mid-epoch resume: the shuffle seed changed ({ckpt_seed} -> "
                            f"{live_seed}); restarting the interrupted epoch")
            resume_skip, resume_group = 0, None
            res.resume_mode, res.resume_reason = "restart", "shuffle seed changed"
        if resume_skip and resume_skip >= _raw_len(train_loader):
            start_epoch += 1
            resume_skip, resume_group = 0, None
            res.resume_mode = "next_epoch"
            res.resume_reason = "the interrupted epoch was already complete"
        if res.resume_mode is None:
            res.resume_mode = "exact" if resume_skip else "epoch_start"
        if resume_meta.get("scheduler"):
            scheduler.load_state_dict(resume_meta["scheduler"])
        if checkpoint is not None and resume_meta.get("best_val") is not None:
            checkpoint.best = float(resume_meta["best_val"])
        if early_stopping is not None and resume_meta.get("early_stop"):
            es = resume_meta["early_stop"]
            if es.get("best") is not None:
                early_stopping.best = float(es["best"])
            early_stopping.count = int(es.get("count", 0))

    # the sentinel's warm-up: the first epoch this process runs captures
    # every graph; after a partial resume the first full epoch may capture
    # the buckets the resumed tail skipped
    sentinel = _Sentinel(start_epoch + (1 if resume_skip else 0), verbosity)

    def epoch_checkpoints(epoch: int, metric: float, saved_best: bool) -> None:
        """The rolling last-good checkpoint (the rollback's target) unless
        the best-model one was written, the epoch's chaos faults, then the
        capture sentinel (after the checkpoints: a strict abort keeps the
        epoch's work)."""
        if res.checkpoint_every_epoch and not saved_best:
            save_checkpoint(state, log_name, epoch, path=path,
                            meta={"rolling": True, "metric": _finite_or_none(metric)})
        if res.chaos is not None:
            res.chaos.on_epoch_end(epoch, log_name, path)
        sentinel.epoch_end(epoch)

    def journal_epoch(epoch: int, t0: float, train_loss, val_loss=None,
                      test_loss=None) -> None:
        """The epoch's journal record and registry gauges (the JAX loop's
        ``_journal_epoch``), from the host's values only."""
        record = {"train_loss": _finite_or_none(train_loss),
                  "duration_s": round(time.monotonic() - t0, 4),
                  "raw_batches": int(res.epoch_raw_done), "skipped": int(res.skipped_total),
                  "lr": float(get_learning_rate(state.optimizer))}
        if val_loss is not None:
            record["val_loss"] = _finite_or_none(val_loss)
        if test_loss is not None:
            record["test_loss"] = _finite_or_none(test_loss)
        tel.emit("epoch", epoch=epoch, **record)
        tel.counter("train_epochs_total").inc()
        tel.publish("train", record)

    def preempt_boundary(epoch: int) -> bool:
        """A stop request at the epoch's end: the resume point is (epoch +
        1, batch 0)."""
        if not res.stop_requested():
            return False
        save_checkpoint(state, log_name, epoch, path=path, meta=preempt_meta(
            epoch + 1, 0, k, n_dev, train_loader, scheduler, checkpoint, early_stopping))
        res.preempted = True
        tel.emit("preempt_checkpoint", epoch=epoch + 1, raw_done=0, mid_epoch=False)
        _log(verbosity, f"Preemption requested: checkpointed after epoch {epoch}")
        return True

    def settle(epoch: int, metric: float, saved: bool) -> bool:
        """The epoch's end: checkpoints, walltime, stop request; True
        stops."""
        epoch_checkpoints(epoch, metric, saved)
        # the ranks of a group stop together
        if walltime_check is not None and res.agree(walltime_check())[0]:
            _log(verbosity, f"Walltime guard tripped at epoch {epoch}")
            return True
        return preempt_boundary(epoch)

    res.bind_group()
    res.install()  # SIGTERM/SIGUSR1 -> a checkpoint request (restored below)
    rollbacks = 0
    epoch = start_epoch
    # HYDRAGNN_TRACE_LEVEL >= 1: a torch.profiler trace of the first epoch
    profiling = int(flags.get(flags.TRACE_LEVEL)) >= 1 and tr.initialize(
        os.path.join(path, log_name, "profile"), enable_profiler=True)
    try:
        while epoch < num_epoch:
            tel.set_context(epoch=epoch)  # the correlation id of every record
            t_epoch = time.perf_counter()
            t_journal = time.monotonic()
            sentinel.epoch_start()
            train_loader.set_epoch(epoch)
            res.current_epoch = epoch
            skip = resume_skip if epoch == start_epoch else 0
            logical = bool(skip) and resume_group is not None
            ep_step, ep_per_step, ep_ndev = superstep, per_step, n_dev
            native = train_loader.grouping()
            if logical:
                # this rank's slots of every saved group, in one eager step
                from ..parallel.comm import world_of

                width = -(-resume_group // world_of())
                slots = tuple(range(rank_of(), rank_of() + width * world_of(), world_of()))
                train_loader.set_group(resume_group, slots=slots)
                ep_step, ep_per_step, ep_ndev = _eager(logical_step), width, resume_group
            if skip:
                train_loader.set_resume_point(skip)
            try:
                train_loss, _ = train_epoch(ep_step, state, train_loader, put, res,
                                            per_step=ep_per_step, n_dev=ep_ndev)
            except DivergenceDetected as e:
                rollbacks += 1
                res.rollbacks += 1
                _rollback_state(state, log_name, path, res, rollbacks, e, verbosity)
                scheduler = ReduceLROnPlateau(get_learning_rate(state.optimizer))
                res.reset_streak()
                resume_skip = 0  # a rollback retrains the epoch whole
                continue
            finally:
                # later epochs (and a retried one) take this group's own grid
                train_loader.set_group(*native)
            rollbacks = 0
            if profiling:
                tr.stop_profiler()
                profiling = False
            if res.skipped_total:
                _log(verbosity, f"non-finite guard: {res.skipped_total} step(s) skipped so far "
                                "this run")
            if res.interrupted:
                raw_total = _raw_len(train_loader)
                raw_done = min(skip + res.epoch_raw_done, raw_total)
                save_checkpoint(state, log_name, epoch, path=path, meta=preempt_meta(
                    epoch, raw_done, k, ep_ndev, train_loader, scheduler, checkpoint,
                    early_stopping))
                res.preempted = True
                tel.emit("preempt_checkpoint", epoch=epoch, raw_done=raw_done,
                         raw_total=raw_total, mid_epoch=True)
                _log(verbosity, f"Preemption requested: checkpointed mid-epoch at epoch "
                                f"{epoch}, batch {raw_done}/{raw_total}")
                break
            record = {"epoch": epoch, "train_loss": train_loss}
            if skip_valtest:
                _log(verbosity, f"Epoch: {epoch:04d}, Train Loss: {train_loss:.8f}")
                journal_epoch(epoch, t_journal, train_loss)
                saved = bool(checkpoint(state, epoch, train_loss)) if checkpoint else False
                record["seconds"] = time.perf_counter() - t_epoch
                if history is not None:
                    history.append(record)
                if settle(epoch, train_loss, saved):
                    break
                epoch += 1
                continue
            val_loss, _, _ = evaluate(eval_step, state, val_loader, put, per_step, "validate")
            test_loss, _, _ = evaluate(eval_step, state, test_loader, put, per_step, "test")
            new_lr = scheduler.step(val_loss)
            if new_lr != get_learning_rate(state.optimizer):
                set_learning_rate(state.optimizer, new_lr)
            _log(verbosity, f"Epoch: {epoch:04d}, Train Loss: {train_loss:.8f}, Val Loss: "
                            f"{val_loss:.8f}, Test Loss: {test_loss:.8f}, LR: {new_lr:.2e}")
            journal_epoch(epoch, t_journal, train_loss, val_loss, test_loss)
            record.update(val_loss=val_loss, test_loss=test_loss, lr=new_lr)
            saved = bool(checkpoint(state, epoch, val_loss)) if checkpoint else False
            record["seconds"] = time.perf_counter() - t_epoch
            if history is not None:
                history.append(record)
            if early_stopping is not None and early_stopping(val_loss):
                _log(verbosity, f"Early stopping at epoch {epoch}")
                epoch_checkpoints(epoch, val_loss, saved)
                break
            if settle(epoch, val_loss, saved):
                break
            epoch += 1
    finally:
        res.uninstall()  # the previous SIGTERM/SIGUSR1 handlers come back
        if profiling:  # no epoch finished
            tr.stop_profiler()
    return state


class _Sentinel:
    """``HYDRAGNN_COMPILE_SENTINEL`` (``warn`` | ``strict``; unset or 0:
    off) over the epochs: the CUDA graphs each epoch captured
    (``analysis.sentinel.compile_counts``), journalled as
    ``compile_sentinel`` with the JAX field name ``new_lowerings``; after
    the warm-up epoch ``warmup_through`` a capture warns or, ``strict``,
    raises ``RecompileError``. A typo raises rather than turn a gate
    off."""

    def __init__(self, warmup_through: int, verbosity: int):
        mode = str(flags.get(flags.COMPILE_SENTINEL) or "").strip().lower()
        if mode in ("", "0", "false", "off"):
            mode = None
        elif mode not in ("warn", "strict"):
            raise ValueError(f"HYDRAGNN_COMPILE_SENTINEL={mode!r}: expected 'warn', 'strict', "
                             "or unset/0")
        self.mode = mode
        self.warmup_through = warmup_through
        self.verbosity = verbosity
        self.at_start = 0

    def epoch_start(self) -> None:
        if self.mode is not None:
            from ..analysis.sentinel import compile_counts

            self.at_start = compile_counts()["captures"]

    def epoch_end(self, epoch: int) -> None:
        if self.mode is None:
            return
        from ..analysis.sentinel import RecompileError, compile_counts

        delta = compile_counts()["captures"] - self.at_start
        if delta:
            tel.emit("compile_sentinel", epoch=epoch, new_lowerings=int(delta),
                     warmup=epoch <= self.warmup_through)
            tel.gauge("compile_lowerings_delta").set(int(delta))
        if epoch <= self.warmup_through or delta == 0:
            return
        msg = (f"compile sentinel: epoch {epoch} captured {delta} new CUDA graph(s) after the "
               "warm-up epoch: a batch signature (bucket, dtype, sortedness certificate) the "
               f"warm-up did not see (HYDRAGNN_COMPILE_SENTINEL={self.mode})")
        if self.mode == "strict":
            raise RecompileError(msg)
        _log(self.verbosity, msg)


_LEDGER_PROBED = False  # one-shot latch (a single flip)


def _ledger_probe(superstep, model: str, precision: str):
    """``superstep`` whose first train step in the process is counted into
    the cost ledger (``telemetry.ledger.count``: the step itself, no extra
    run) when ``HYDRAGNN_LEDGER`` names a save path and capture is on; the
    JAX loop's ``_maybe_ledger_probe`` for a route that captures no graph.
    Otherwise ``superstep`` itself."""
    from ..capture import bucket_of
    from ..telemetry import ledger

    if _LEDGER_PROBED or ledger.save_path() is None or not ledger.capture_enabled():
        return superstep
    step = _step_of(superstep)

    def probed(state, batch):
        global _LEDGER_PROBED
        if _LEDGER_PROBED:
            return step(state, batch)
        _LEDGER_PROBED = True
        out, counts = ledger.count(step, state, batch)
        one = batch[0] if isinstance(batch, tuple) else batch
        ledger.record(counts, model=model, bucket=bucket_of(one), kind="train_step",
                      precision=precision, backend=one.device.type)
        return out

    return SimpleNamespace(k=getattr(superstep, "k", 1), dispatch=probed)


__all__ = ["MAX_IN_FLIGHT", "accumulate", "evaluate", "preempt_meta", "reshard_resume_reason",
           "test", "train_epoch", "train_validate_test"]
