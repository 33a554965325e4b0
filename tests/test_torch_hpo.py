"""The port's hyperparameter search (``hydragnn_tpu_torch/utils/hpo.py``) and
A/B verdicts (``utils/abtest.py``) against the JAX package's, on the CPU.

- the samplers draw the JAX package's assignments for the same seed;
- ``run_hpo`` (random, vmap) gives the JAX package's histories, best
  configurations and vmap partitions for the same objectives; failed trials
  are recorded, diverged members never win; ``backend="optuna"`` without
  optuna raises ``ImportError`` (the JAX package falls back to random
  search; the port moves to no other search quietly);
- ``subprocess_objective``'s crash, timeout and record contracts, and its
  default worker training the port in a subprocess;
- the population objective's member results against the JAX package's
  plain single-member runs from the same initialisation: validation losses
  after an AdamW epoch at ``test_torch_train_loop.py``'s ``EVAL_RTOL``
  (6e-2: Adam moves a bias whose exact gradient is 0 by up to ``lr`` in the
  direction of its fp32 noise, differently on the two sides; eval mode does
  not cancel it), the diverged member's ``inf`` exactly.
"""

import copy
import json
from collections import Counter

import numpy as np
import pytest

import torch_port_util as tpu
from hydragnn_tpu.utils import abtest as jax_abtest
from hydragnn_tpu.utils import hpo as jax_hpo
from hydragnn_tpu_torch.utils import abtest, hpo
from test_config import CI_CONFIG
from test_torch_train_loop import EVAL_RTOL

SPACE = {
    "NeuralNetwork.Architecture.hidden_dim": [4, 8, 16, 32],
    "NeuralNetwork.Training.Optimizer.learning_rate": ("log_float", 1e-4, 1e-1),
    "NeuralNetwork.Training.Optimizer.weight_decay": ("float", 0.0, 0.1),
    "NeuralNetwork.Architecture.num_conv_layers": ("int", 1, 4),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_samplers_draw_the_jax_assignments(seed):
    for n in (1, 5, 12):
        assert hpo.sample_unique_assignments(SPACE, np.random.default_rng(seed), n) == \
            jax_hpo.sample_unique_assignments(SPACE, np.random.default_rng(seed), n)
    assert hpo.sample_config(SPACE, np.random.default_rng(seed)) == \
        jax_hpo.sample_config(SPACE, np.random.default_rng(seed))
    small = {"x": [1, 2, 3]}
    assert hpo.sample_unique_assignments(small, np.random.default_rng(seed), 10) == \
        jax_hpo.sample_unique_assignments(small, np.random.default_rng(seed), 10)
    with pytest.raises(ValueError, match="bad search-space entry"):
        hpo.sample_config({"x": ("gauss", 0, 1)}, np.random.default_rng(seed))


def _objective(cfg):
    arch = cfg["NeuralNetwork"]["Architecture"]
    lr = cfg["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"]
    if arch["hidden_dim"] == 32 and arch["num_conv_layers"] == 4:
        raise ValueError("worker blew up")
    return float(abs(np.log10(lr) + 2.5) + arch["num_conv_layers"] / 10)


def _fake_population_objective(calls):
    def pop_obj(cfg_static, members):
        calls.append((cfg_static, members))
        out = []
        for i, m in enumerate(members):
            lr = float(m["NeuralNetwork.Training.Optimizer.learning_rate"])
            out.append((float("inf"), "diverged") if lr > 0.05 else (lr, "ok"))
        return out

    return pop_obj


@pytest.mark.parametrize("backend", ["random", "vmap"])
def test_run_hpo_matches_jax_histories_partitions_and_best(backend, tmp_path):
    """The same space, seed and objectives in both packages: the same
    history (assignments, values, statuses, modes, error texts), the same
    vmap groups (the same base configs and members, in order), the same
    best, and the same log file."""
    base = copy.deepcopy(CI_CONFIG)
    space = {k: SPACE[k] for k in ("NeuralNetwork.Architecture.hidden_dim",
                                   "NeuralNetwork.Training.Optimizer.learning_rate",
                                   "NeuralNetwork.Architecture.num_conv_layers")}
    ours_calls, theirs_calls = [], []
    kw = {"n_trials": 12, "seed": 3, "backend": backend}
    ours = hpo.run_hpo(copy.deepcopy(base), space, _objective, log_path=str(tmp_path / "a.json"),
                       population_objective=_fake_population_objective(ours_calls), **kw)
    theirs = jax_hpo.run_hpo(copy.deepcopy(base), space, _objective,
                             log_path=str(tmp_path / "b.json"),
                             population_objective=_fake_population_objective(theirs_calls),
                             **kw)
    assert ours[0] == theirs[0] and ours[1] == theirs[1]
    assert ours[2] == theirs[2]
    assert ours_calls == theirs_calls
    assert json.load(open(tmp_path / "a.json")) == json.load(open(tmp_path / "b.json"))
    statuses = Counter(h["status"] for h in ours[2])
    if backend == "vmap":
        modes = Counter(h["mode"] for h in ours[2])
        assert modes["vmap"] >= 2 and len(ours_calls) >= 1
        assert statuses["diverged"] >= 1
        assert all(h["status"] != "diverged" or h["value"] == float("inf") for h in ours[2])
    assert ours[1] == min(h["value"] for h in ours[2] if h["status"] == "ok")


def test_failed_trials_recorded_and_all_failed_raises():
    def objective(cfg):
        if cfg["x"] == 2:
            raise ValueError("worker blew up")
        return float(cfg["x"])

    _, best, hist = hpo.run_hpo({"x": 0}, {"x": [1, 2, 3]}, objective, n_trials=9, seed=0)
    failed = [h for h in hist if h["status"] == "failed"]
    assert failed and all("worker blew up" in h["error"] and h["value"] == float("inf")
                          for h in failed)
    assert best == 1.0
    with pytest.raises(RuntimeError, match="boom"):
        hpo.run_hpo({"x": 0}, {"x": [1, 2]},
                    lambda cfg: (_ for _ in ()).throw(ValueError("boom")), n_trials=4, seed=0)


def test_optuna_backend_raises_without_optuna(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_optuna(name, *args, **kwargs):
        if name == "optuna":
            raise ImportError("No module named 'optuna'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_optuna)
    with pytest.raises(ImportError, match="optuna"):
        hpo.run_hpo({"x": 0}, {"x": [1, 2]}, lambda c: 0.0, n_trials=2, backend="optuna")


def test_subprocess_objective_contracts(tmp_path):
    """A crashing worker and one past its timeout score inf; a worker's
    objective and the ``keep_dir`` records (with the sampled assignment)."""
    crash = tmp_path / "crash.py"
    crash.write_text("import sys; sys.exit(3)\n")
    assert hpo.subprocess_objective(str(crash), timeout=30)({"a": 1}) == float("inf")
    slow = tmp_path / "slow.py"
    slow.write_text("import time; time.sleep(60)\n")
    assert hpo.subprocess_objective(str(slow), timeout=1)({"a": 1}) == float("inf")
    ok = tmp_path / "ok.py"
    ok.write_text("import json, sys\ncfg = json.load(open(sys.argv[1]))\n"
                  "json.dump({'objective': float(cfg['x'])}, open(sys.argv[2], 'w'))\n")
    keep = tmp_path / "keep"
    obj = hpo.subprocess_objective(str(ok), timeout=60, keep_dir=str(keep))
    _, best, hist = hpo.run_hpo({"x": 0}, {"x": [1, 2, 3]}, obj, n_trials=3, seed=1)
    recs = [json.loads(p.read_text()) for p in sorted(keep.glob("trial_*.json"))]
    assert best == 1.0 and len(recs) == len(hist) == 3
    assert {json.dumps(r["assignment"], sort_keys=True) for r in recs} == \
        {json.dumps(h["assignment"], sort_keys=True) for h in hist}
    assert all(r["status"] == "ok" for r in recs)


def test_default_worker_trains_the_port_in_a_subprocess(tmp_path):
    """``subprocess_objective()`` with no script runs this module's worker:
    the port's ``run_training`` on a config whose data are files
    (``Dataset.path``), on the CPU (``HYDRAGNN_HPO_DEVICE``), writing the
    last epoch's validation loss."""
    import chip_smoke

    data = tmp_path / "qm9"
    chip_smoke.write_qm9_xyz_dir(str(data), 40, 0)
    cfg = json.load(open("examples/qm9/qm9.json"))
    cfg["Dataset"]["path"]["total"] = str(data)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=8, num_conv_layers=1)
    arch["output_heads"]["graph"].update(dim_sharedlayers=8, dim_headlayers=[8, 8])
    cfg["NeuralNetwork"]["Training"].update(num_epoch=1, batch_size=8, precision="fp32")
    cfg["Visualization"]["create_plots"] = False
    obj = hpo.subprocess_objective(timeout=300, keep_dir=str(tmp_path / "keep"),
                                   extra_env={"HYDRAGNN_HPO_DEVICE": "cpu"})
    value = obj(cfg)
    rec = json.load(open(next((tmp_path / "keep").glob("trial_*.json"))))
    assert np.isfinite(value) and value > 0, rec
    assert rec["status"] == "ok" and rec["returncode"] == 0


def test_abba_verdicts_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        k = int(rng.integers(2, 9))
        a = list(rng.normal(10.0, rng.uniform(0.01, 1.0), k))
        b = list(np.asarray(a) * rng.uniform(0.9, 1.2) + rng.normal(0, 0.1, k))
        budget = float(rng.uniform(0.5, 10.0))
        assert abtest.abba_verdict(a, b, budget) == jax_abtest.abba_verdict(a, b, budget)
        assert abtest.iqr(a) == jax_abtest.iqr(a)


def test_population_objective_members_match_jax_single_member_runs(monkeypatch):
    """``run_hpo(backend="vmap")``'s population objective: each member's
    objective (its validation loss after the configured epochs) against the
    JAX package's plain single-member epoch from the same initialisation
    (the JAX state converted into every member) with its learning rate,
    and a diverged member's inf."""
    from hydragnn_tpu.datasets import deterministic_graph_data
    from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jl
    from hydragnn_tpu.train.loop import evaluate as jax_evaluate
    from hydragnn_tpu.train.loop import train_epoch as jax_train_epoch
    from hydragnn_tpu.train.optimizer import set_learning_rate
    from hydragnn_tpu.train.step import make_eval_step as jax_eval_step
    from hydragnn_tpu_torch.convert import load_jax_population
    from hydragnn_tpu_torch.train import population as P
    from test_torch_population import _stacked, setup

    s = setup("gin")
    lrs = [0.02, 0.005, 1e30]
    cfg = copy.deepcopy(s.cfg)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 1
    samples = deterministic_graph_data(number_configurations=100, seed=7)
    made = []
    real_create = P.create_population_state

    def from_jax(config, n, **kw):
        pstate = real_create(config, n, **kw)
        made.append(pstate)
        return load_jax_population(pstate, _stacked(tpu.numpy_tree(s.jstate.params), n),
                                   _stacked(tpu.numpy_tree(s.jstate.batch_stats), n))

    monkeypatch.setattr(P, "create_population_state", from_jax)
    objective = P.make_population_objective(samples=tpu.port_samples(samples), device="cpu")
    results = objective(cfg, [{"NeuralNetwork.Training.Optimizer.learning_rate": lr}
                              for lr in lrs])
    assert len(made) == 1 and [st for _, st in results] == ["ok", "ok", "ok"]
    assert results[2][0] == float("inf")
    jeval = jax_eval_step(s.jmodel)
    jtrain, jval, _ = jl(copy.deepcopy(cfg), samples=tpu.jax_samples_copy(samples))
    for i, lr in enumerate(lrs[:2]):
        js = s.jstate._replace(opt_state=set_learning_rate(s.jstate.opt_state, lr))
        jtrain.set_epoch(0)
        js, _, _ = jax_train_epoch(s.jstep, js, jtrain)
        want, _, _ = jax_evaluate(jeval, js, jval)
        np.testing.assert_allclose(results[i][0], float(want), rtol=EVAL_RTOL["AdamW"],
                                   err_msg=f"member {i}")
