"""Hyperparameter optimization: random search, Optuna, and populations.

Counterpart of ``hydragnn_tpu/utils/hpo.py``: a self-contained random
search (search-space dict -> objective -> best config), Optuna's sampler
when ``optuna`` is installed (``backend="optuna"``; without it that
backend raises ``ImportError``: the port moves to no other search quietly),
and ``backend="vmap"``. The samplers draw the JAX package's assignments for
the same seed (numpy's generator, the same calls in the same order).

``backend="vmap"`` trains trials whose assignments differ only in scalars
the population state carries as tensors (learning rate, weight decay, loss
weights: ``train/population.py::VMAP_SCALAR_KEYS``) as ONE population in
process: one captured step and one dispatch stream for the group instead
of one per trial. Assignments that change the model go through the
per-trial ``objective`` (the subprocess path), partitioned so that every
group that can train as a population does.

``subprocess_objective`` runs each trial in its own process: by default
this module's worker (``python -m hydragnn_tpu_torch.utils.hpo config.json
out.json [device]``), which trains the port's ``run_training`` and writes
the last epoch's validation loss.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import time
from typing import Any, Callable

import numpy as np


def subprocess_objective(
    worker: str | None = None,
    timeout: float = 600.0,
    python: str | None = None,
    extra_env: dict | None = None,
    keep_dir: str | None = None,
) -> Callable[[dict], float]:
    """Trial evaluator that runs each configuration in its OWN OS process —
    the reference's DeepHyper ``ProcessPoolEvaluator``/srun pattern
    (``examples/multidataset_hpo/gfm_deephyper_multi.py:127-170``). Pass the
    returned callable to ``run_hpo(..., workers=N)`` for N concurrent trials:
    the thread pool just supervises; the training itself runs in separate
    interpreters, so no CUDA or torch state is shared across trials.

    ``worker`` is a script invoked as ``python worker config.json out.json``
    that trains the config and writes ``{"objective": <float>}``; None runs
    this module's worker (:func:`main`: the port's ``run_training`` on the
    card, or on the CPU when ``extra_env`` sets ``HYDRAGNN_HPO_DEVICE=cpu``). A trial
    that overruns ``timeout``, crashes, or writes garbage scores ``inf``
    (diverged-trial semantics — never beats a finite value). ``keep_dir``
    saves each trial's record (objective, wall-clock span, returncode, and
    the sampled ``assignment`` — ``run_hpo`` passes it through, so the
    records are self-describing) as ``trial_<n>.json`` for post-hoc
    analysis/concurrency audits."""
    import subprocess
    import sys

    counter = itertools.count()

    def objective(cfg: dict, assignment: dict | None = None) -> float:
        import tempfile

        idx = next(counter)
        t0 = time.time()
        value, rc, err = float("inf"), None, None
        with tempfile.TemporaryDirectory() as td:
            cfg_path = os.path.join(td, "config.json")
            out_path = os.path.join(td, "out.json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
            env = dict(os.environ)
            if worker is None:
                # the worker imports this checkout
                root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
                    __file__))))
                env["PYTHONPATH"] = os.pathsep.join(
                    [root] + [p for p in [env.get("PYTHONPATH")] if p])
            env.update(extra_env or {})
            try:
                command = [worker] if worker is not None else ["-m", __name__]
                r = subprocess.run(
                    [python or sys.executable, *command, cfg_path, out_path],
                    timeout=timeout, capture_output=True, text=True, env=env,
                )
                rc = r.returncode
                if rc == 0:
                    with open(out_path) as f:
                        value = float(json.load(f)["objective"])
                else:
                    err = r.stderr[-2000:]
            except Exception as exc:  # timeout, missing/garbled out.json, ...
                err = f"{type(exc).__name__}: {exc}"
        t1 = time.time()
        if keep_dir:
            # status taxonomy mirrors run_hpo's: a trial the resilience
            # layer aborted (TrainingDivergedError in its stderr) or that
            # returned a non-finite objective is "diverged"; any other
            # crash/timeout is "failed"
            if np.isfinite(value):
                status = "ok"
            elif err and "TrainingDivergedError" in err:
                status = "diverged"
            elif rc == 0:
                status = "diverged"  # clean exit, non-finite objective
            else:
                status = "failed"
            os.makedirs(keep_dir, exist_ok=True)
            with open(os.path.join(keep_dir, f"trial_{idx:03d}.json"), "w") as f:
                json.dump(
                    {"objective": value, "status": status, "t_start": t0,
                     "t_end": t1, "returncode": rc, "error": err,
                     "assignment": assignment},
                    f,
                )
        return value

    return objective


def sample_config(space: dict[str, Any], rng: np.random.Generator) -> dict:
    """Draw one assignment from a search-space dict. Entries may be:
    list -> categorical; ("int", lo, hi) / ("float", lo, hi) /
    ("log_float", lo, hi) -> ranges."""
    out = {}
    for key, spec in space.items():
        if isinstance(spec, list):
            out[key] = spec[rng.integers(len(spec))]
        elif isinstance(spec, tuple) and spec[0] == "int":
            out[key] = int(rng.integers(spec[1], spec[2] + 1))
        elif isinstance(spec, tuple) and spec[0] == "float":
            out[key] = float(rng.uniform(spec[1], spec[2]))
        elif isinstance(spec, tuple) and spec[0] == "log_float":
            out[key] = float(np.exp(rng.uniform(np.log(spec[1]), np.log(spec[2]))))
        else:
            raise ValueError(f"bad search-space entry {key}: {spec}")
    return out


def _assignment_key(assignment: dict) -> str:
    """Canonical hashable form of an assignment (values may be lists, e.g.
    task-weight vectors)."""
    return json.dumps(assignment, sort_keys=True, default=str)


def sample_unique_assignments(
    space: dict[str, Any],
    rng: np.random.Generator,
    n_trials: int,
    max_attempts: int | None = None,
) -> list[dict]:
    """Up to ``n_trials`` DISTINCT assignments. Small categorical spaces used
    to burn trials re-running identical configs (4 options, 12 trials ->
    ~8 duplicate trainings); re-drawing duplicates instead spends the budget
    on coverage, and a space with fewer than ``n_trials`` distinct points
    simply yields them all (the attempt cap keeps exhausted spaces from
    looping forever)."""
    seen: set = set()
    out: list[dict] = []
    attempts = 0
    cap = max_attempts or max(20 * n_trials, 100)
    while len(out) < n_trials and attempts < cap:
        attempts += 1
        assignment = sample_config(space, rng)
        key = _assignment_key(assignment)
        if key not in seen:
            seen.add(key)
            out.append(assignment)
    return out


def _set_by_path(config: dict, dotted: str, value) -> None:
    node = config
    keys = dotted.split(".")
    for k in keys[:-1]:
        node = node[k]
    node[keys[-1]] = value


def run_hpo(
    base_config: dict,
    space: dict[str, Any],
    objective: Callable[[dict], float],
    n_trials: int = 10,
    seed: int = 0,
    backend: str = "random",
    log_path: str | None = None,
    workers: int = 1,
    walltime_budget: float | None = None,
    population_objective: Callable[[dict, list], list] | None = None,
) -> tuple[dict, float, list]:
    """Minimize ``objective(config)`` over ``space``. Space keys are dotted
    config paths (e.g. ``"NeuralNetwork.Architecture.hidden_dim"``).
    Returns (best_config, best_value, trial history).

    ``workers > 1`` evaluates random-search trials concurrently through a
    thread pool (the reference's DeepHyper ProcessPoolEvaluator width,
    ``examples/multidataset_hpo/gfm_deephyper_multi.py``) — the objective
    must be thread-safe, e.g. ``subprocess_objective``. ``walltime_budget``
    (seconds) stops LAUNCHING new trials once spent; in-flight trials finish
    and count.

    ``backend="vmap"``: trials differing only in vmappable scalars
    (``train/population.py::VMAP_SCALAR_KEYS``) train as ONE in-process
    vmapped population per architecture group via ``population_objective``
    (default: ``make_population_objective()`` reading data from the
    config's ``Dataset`` section); single-assignment groups with
    architecture-changing keys fall back to the per-trial ``objective``."""
    history = []
    deadline = time.monotonic() + walltime_budget if walltime_budget else None

    def expired() -> bool:
        return deadline is not None and time.monotonic() > deadline

    def build(assignment: dict) -> dict:
        cfg = copy.deepcopy(base_config)
        for key, val in assignment.items():
            _set_by_path(cfg, key, val)
        return cfg

    import inspect

    # Does the objective accept (config, assignment=...)? Probed with a bind
    # — a mere `"assignment" in parameters` check wrongly matches objectives
    # whose FIRST positional happens to be named `assignment` (and would
    # call them with the config twice).
    try:
        inspect.signature(objective).bind({}, assignment={})
        _takes_assignment = True
    except (TypeError, ValueError):  # doesn't fit, or C callable w/o signature
        _takes_assignment = False

    def evaluate(assignment: dict) -> tuple[float, str, str | None]:
        """(objective value, status, error text). A trial killed by the
        resilience layer's divergence abort (``TrainingDivergedError``) is a
        *result* — status ``"diverged"``, objective inf — not a
        sweep-crashing exception; a finite value is ``"ok"``; any other
        non-finite value also records ``"diverged"`` (the pre-existing
        NaN/inf objective semantics, now labeled). Any OTHER exception
        records status ``"failed"`` (objective inf) with the exception text
        preserved in the history entry — one crashed trial must not discard
        every completed one (this is what keeps an optuna study alive too;
        it used to append nothing and die), but a systematic setup bug must
        still be diagnosable from the record."""
        from ..resilience import TrainingDivergedError

        try:
            cfg = build(assignment)
            value = float(
                objective(cfg, assignment=assignment)
                if _takes_assignment else objective(cfg)
            )
        except TrainingDivergedError as exc:
            return float("inf"), "diverged", f"{type(exc).__name__}: {exc}"
        except Exception as exc:
            return float("inf"), "failed", f"{type(exc).__name__}: {exc}"
        return value, ("ok" if np.isfinite(value) else "diverged"), None

    def record(history_entry: dict, error: str | None) -> dict:
        if error is not None:
            history_entry["error"] = error
        history.append(history_entry)
        return history_entry

    if backend == "vmap":
        return _run_vmap_backend(
            base_config, space, evaluate, build, population_objective,
            n_trials, seed, expired, history, log_path,
        )
    if backend == "optuna":
        try:
            import optuna
        except ImportError as exc:
            raise ImportError("run_hpo(backend='optuna') needs the optuna package; use "
                              "backend='random' or 'vmap' without it") from exc
        def opt_objective(trial):
            assignment = {}
            for key, spec in space.items():
                if isinstance(spec, list):
                    assignment[key] = trial.suggest_categorical(key, spec)
                elif spec[0] == "int":
                    assignment[key] = trial.suggest_int(key, spec[1], spec[2])
                elif spec[0] == "float":
                    assignment[key] = trial.suggest_float(key, spec[1], spec[2])
                else:
                    assignment[key] = trial.suggest_float(key, spec[1], spec[2], log=True)
            value, status, err = evaluate(assignment)
            record(
                {"assignment": assignment, "value": value, "status": status}, err
            )
            return value

        study = optuna.create_study(direction="minimize")
        # optuna implements the walltime budget natively (stops launching new
        # trials once spent — same semantics as the random branch below)
        study.optimize(opt_objective, n_trials=n_trials,
                       n_jobs=max(workers, 1), timeout=walltime_budget)
        if not any(h["status"] == "ok" for h in history):
            # evaluate() folds exceptions into inf-scored COMPLETE trials to
            # keep the study alive, so optuna would happily crown an
            # arbitrary inf "best" — die loudly like the other backends
            raise RuntimeError(_all_failed_msg(len(history), history))
        best_assignment = study.best_params
        best_value = study.best_value
    else:
        rng = np.random.default_rng(seed)
        # duplicates re-draw instead of re-training: a small categorical
        # space may yield FEWER than n_trials (every distinct point covered)
        assignments = sample_unique_assignments(space, rng, n_trials)
        n_avail = len(assignments)
        values: list = [None] * n_avail
        if workers > 1:
            from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

            with ThreadPoolExecutor(max_workers=workers) as pool:
                pending: dict = {}
                i = 0
                while i < n_avail or pending:
                    while i < n_avail and len(pending) < workers and not expired():
                        fut = pool.submit(evaluate, assignments[i])
                        pending[fut] = i
                        i += 1
                    if not pending:
                        break
                    done, _ = wait(pending, return_when=FIRST_COMPLETED)
                    for fut in done:
                        values[pending.pop(fut)] = fut.result()
                    if expired():
                        i = n_avail  # budget spent: drain in-flight, launch no more
        else:
            for i, a in enumerate(assignments):
                if expired():
                    break
                values[i] = evaluate(a)
        best_assignment, best_value = None, float("inf")
        launched = 0
        for assignment, result in zip(assignments, values):
            if result is None:
                continue  # budget cap: trial never launched
            value, status, err = result
            launched += 1
            record(
                {"assignment": assignment, "value": value, "status": status}, err
            )
            # diverged trials (NaN/inf objective or divergence-abort) never
            # beat any finite value — excluded from best-trial selection
            if status == "ok" and value < best_value:
                best_assignment, best_value = assignment, value
        if best_assignment is None:
            if launched == 0:
                raise RuntimeError(
                    "HPO walltime budget expired before any trial completed "
                    "— increase walltime_budget or shrink per-trial cost "
                    "(this is a budget misconfiguration, not diverged trials)"
                )
            raise RuntimeError(_all_failed_msg(launched, history))

    if log_path:
        _write_hpo_log(log_path, best_assignment, best_value, history)
    return build(best_assignment), best_value, history


def _all_failed_msg(launched: int, history: list) -> str:
    """The all-trials-dead diagnosis: statuses/values plus the LAST recorded
    error text, so a systematic setup bug (typo'd space key, missing dep)
    surfaces in the exception instead of hiding behind N anonymous infs."""
    msg = (
        f"all {launched} launched HPO trials diverged or failed "
        f"(history: {[(h['status'], h['value']) for h in history]})"
    )
    errors = [h["error"] for h in history if h.get("error")]
    if errors:
        msg += f"; last error: {errors[-1]}"
    return msg


def _write_hpo_log(log_path, best_assignment, best_value, history) -> None:
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    with open(log_path, "w") as f:
        json.dump(
            {"best": best_assignment, "value": best_value, "trials": history},
            f,
            indent=2,
        )


def main(argv: list[str] | None = None) -> int:
    """The default trial worker: ``config.json out.json [device]`` trains the
    configuration with the port's ``run_training`` (on ``device``, else
    ``HYDRAGNN_HPO_DEVICE``, else the card; logs under the out file's
    directory) and writes ``{"objective": <last epoch's validation loss,
    its train loss without a validation split>}``."""
    import sys

    args = sys.argv[1:] if argv is None else argv
    if len(args) not in (2, 3):
        print("usage: python -m hydragnn_tpu_torch.utils.hpo config.json out.json [device]",
              file=sys.stderr)
        return 2
    from ..run_training import run_training

    with open(args[0]) as f:
        config = json.load(f)
    device = args[2] if len(args) == 3 else os.environ.get("HYDRAGNN_HPO_DEVICE", "cuda")
    history: list = []
    run_training(config, device=device, path=os.path.join(os.path.dirname(
        os.path.abspath(args[1])), "logs"), history=history)
    last = history[-1] if history else {}
    value = last.get("val_loss", last.get("train_loss", float("inf")))
    with open(args[1], "w") as f:
        json.dump({"objective": float(value)}, f)
    return 0


def _run_vmap_backend(
    base_config, space, evaluate, build, population_objective,
    n_trials, seed, expired, history, log_path,
) -> tuple[dict, float, list]:
    """The ``backend="vmap"`` engine: partition deduplicated assignments into
    vmappable groups and train each group as ONE population program.

    Grouping key = the values of every NON-vmappable (architecture-changing)
    space key: within a group the compiled program is identical, so the
    members' scalars (lr / weight decay / loss weights) ride the stacked
    state. A group of one that carries architecture keys gains nothing from
    vmap and goes through the per-trial ``objective`` instead (the
    subprocess path — an architecture change needs a fresh program anyway).
    History entries match the random backend's contract (assignment/value/
    status) plus a ``mode`` field ("vmap" | "fallback") recording how each
    trial actually ran.

    Semantics that differ from the random backend, by design: the walltime
    budget is checked BETWEEN groups (a vmapped population is one in-flight
    unit — like the random backend's in-flight trials, a launched group
    trains to completion), and groups evaluate serially (``workers`` has no
    effect here; an architecture-dominated space that mostly falls back is
    better served by ``backend="random"`` with workers)."""
    from ..train.population import VMAP_SCALAR_KEYS

    scalar_keys = [k for k in space if k in VMAP_SCALAR_KEYS]
    arch_keys = [k for k in space if k not in VMAP_SCALAR_KEYS]
    rng = np.random.default_rng(seed)
    assignments = sample_unique_assignments(space, rng, n_trials)
    if population_objective is None:
        from ..train.population import make_population_objective

        population_objective = make_population_objective()

    groups: dict[str, list] = {}
    for a in assignments:
        sig = _assignment_key({k: a[k] for k in arch_keys})
        groups.setdefault(sig, []).append(a)

    from ..resilience import TrainingDivergedError

    best_assignment, best_value = None, float("inf")
    launched = 0
    for group in groups.values():
        if expired():
            break
        if arch_keys and len(group) == 1:
            results, mode = [evaluate(group[0])], "fallback"
        else:
            cfg_static = build({k: group[0][k] for k in arch_keys})
            members = [{k: a[k] for k in scalar_keys} for a in group]
            try:
                # population objectives return (value, status) pairs;
                # normalize to the evaluate() triple (no per-member error)
                results = [
                    (value, status, None)
                    for value, status in population_objective(cfg_static, members)
                ]
            except TrainingDivergedError as exc:
                err = f"{type(exc).__name__}: {exc}"
                results = [(float("inf"), "diverged", err)] * len(group)
            except Exception as exc:
                err = f"{type(exc).__name__}: {exc}"
                results = [(float("inf"), "failed", err)] * len(group)
            mode = "vmap"
        for a, (value, status, err) in zip(group, results):
            launched += 1
            value = float(value)
            entry = {"assignment": a, "value": value, "status": status, "mode": mode}
            if err is not None:
                entry["error"] = err
            history.append(entry)
            if status == "ok" and np.isfinite(value) and value < best_value:
                best_assignment, best_value = a, value
    if best_assignment is None:
        if launched == 0:
            raise RuntimeError(
                "HPO walltime budget expired before any trial completed "
                "— increase walltime_budget or shrink per-trial cost "
                "(this is a budget misconfiguration, not diverged trials)"
            )
        raise RuntimeError(_all_failed_msg(launched, history))
    if log_path:
        _write_hpo_log(log_path, best_assignment, best_value, history)
    return build(best_assignment), best_value, history


if __name__ == "__main__":
    raise SystemExit(main())
