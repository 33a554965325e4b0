"""The port's resilience layer (``hydragnn_tpu_torch/resilience/``,
``train/loop.py``'s threading of it, the checkpoint's mid-epoch sidecar,
``GraphLoader.set_resume_point``) on the CPU, mirroring the JAX package's
``tests/test_resilience.py:107-646`` and held against that package where the
two compute the same thing: the config block's defaults, the guard's
``"auto"`` policy, the fault plan's parse, the loader's resume plan.

The port's steps run in this process on the tier-1 canary GIN
(``tests/test_config.py``), fp32. Tolerances: every comparison here is bit
for bit (a skipped step leaves the state as it was; a finite guarded step
is the unguarded step; an exact resume in a fresh process ends on the
uninterrupted run's state), except the learning rate after a rollback,
held to rtol 1e-12 (a float64 product).
"""

import copy
import glob
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.config import update_config
from hydragnn_tpu_torch.datasets.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.graphs.batching import GraphLoader
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.preprocess.load_data import apply_variables_of_interest
from hydragnn_tpu_torch.resilience import (DivergenceDetected, FaultPlan, Resilience,
                                           SkipTracker, TrainingDivergedError, Watchdog,
                                           config_defaults, state_tensors,
                                           wrap_step_with_guard)
from hydragnn_tpu_torch.resilience.chaos import corrupt_checkpoint, poison_batch
from hydragnn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from hydragnn_tpu_torch.train.loop import train_epoch, train_validate_test
from hydragnn_tpu_torch.train.optimizer import get_learning_rate
from hydragnn_tpu_torch.train.step import create_train_state, make_train_step
from test_config import CI_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(n_samples=48, seed=9):
    cfg = copy.deepcopy(CI_CONFIG)
    samples = apply_variables_of_interest(
        deterministic_graph_data(number_configurations=n_samples, seed=seed), cfg)
    aug = update_config(cfg, samples)
    return aug, samples


def _state(aug):
    model = create_model_config(copy.deepcopy(aug), device="cpu", seed=0)
    return create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"], seed=0)


def _batches(samples, n=4, batch=4):
    return list(GraphLoader(samples[:n * batch], batch))


def _snapshot(state) -> list:
    return [t.detach().clone() for t in state_tensors(state)]


def _assert_bits(a: list, b: list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y), "state tensor diverged"


def _finite(state) -> bool:
    return all(torch.isfinite(t).all() for t in state_tensors(state))


# -- the config block and the switches ---------------------------------------


def test_schema_fills_the_jax_packages_resilience_defaults():
    from hydragnn_tpu.config import update_config as jax_update_config
    from hydragnn_tpu.datasets import deterministic_graph_data as jax_data
    from hydragnn_tpu.preprocess import apply_variables_of_interest as jax_apply

    aug, samples = _setup(n_samples=8)
    cfg = copy.deepcopy(CI_CONFIG)
    jaug = jax_update_config(cfg, jax_apply(jax_data(number_configurations=8, seed=1), cfg))
    port, jax = aug["NeuralNetwork"]["Training"]["resilience"], \
        jaug["NeuralNetwork"]["Training"]["resilience"]
    assert port == jax and port["nonfinite_guard"] == "auto"
    assert port["max_consecutive_skips"] == 25 and port["rollback_lr_factor"] == 0.5
    bad = copy.deepcopy(CI_CONFIG)
    bad["NeuralNetwork"]["Training"]["resilience"] = "yes please"
    with pytest.raises(ValueError, match="resilience"):
        update_config(bad, samples)


@pytest.mark.parametrize("training", [
    {"precision": "bf16"}, {"precision": "bfloat16"}, {"precision": "fp16"},
    {"precision": "fp32"}, {"precision": "fp64"}, {},
    {"precision": "fp32", "resilience": {"nonfinite_guard": True}},
    {"precision": "bf16", "resilience": {"nonfinite_guard": False}},
])
def test_guard_auto_policy_matches_the_jax_package(training):
    from hydragnn_tpu.resilience import Resilience as JaxResilience

    got = Resilience.from_config(training).guard_enabled
    assert got == JaxResilience.from_config(training).guard_enabled
    assert got == (training.get("resilience", {}).get("nonfinite_guard", training.get(
        "precision") in ("bf16", "bfloat16", "fp16")))


def test_flags_override_the_guard_and_elastic(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_NONFINITE_GUARD", "0")
    assert Resilience.from_config({"resilience": {"nonfinite_guard": True}}).guard_enabled \
        is False
    monkeypatch.setenv("HYDRAGNN_NONFINITE_GUARD", "1")
    assert Resilience.from_config({"precision": "fp32"}).guard_enabled is True
    monkeypatch.setenv("HYDRAGNN_ELASTIC", "1")
    monkeypatch.setenv("HYDRAGNN_WATCHDOG_DISPATCH_S", "2.5")
    res = Resilience.from_config({})
    assert res.elastic is True and res.dispatch_watchdog.timeout_s == 2.5
    assert set(config_defaults()) == set(Resilience.CONFIG_KEYS)


# -- the non-finite guard ----------------------------------------------------


def test_guard_skips_a_nonfinite_step_with_the_state_bit_unchanged():
    aug, samples = _setup()
    batches = _batches(samples)
    state = _state(aug)
    step = wrap_step_with_guard(make_train_step())
    m1 = step(state, batches[0])
    assert int(m1["skipped"]) == 0 and torch.isfinite(m1["loss"])
    before = _snapshot(state)
    m2 = step(state, poison_batch(batches[0]))
    assert int(m2["skipped"]) == 1
    assert float(m2["loss"]) == 0.0 and float(m2["num_graphs"]) == 0.0
    _assert_bits(before, _snapshot(state))
    m3 = step(state, batches[1])
    assert int(m3["skipped"]) == 0 and _finite(state)


def test_a_finite_guarded_step_is_the_unguarded_step_bit_for_bit():
    aug, samples = _setup()
    batches = _batches(samples)
    guarded, plain = _state(aug), _state(aug)
    g, p = wrap_step_with_guard(make_train_step()), make_train_step()
    for b in batches:
        mg, mp = g(guarded, b), p(plain, b)
        assert torch.equal(mg["loss"], mp["loss"])
    _assert_bits(_snapshot(guarded), _snapshot(plain))


def test_guard_skips_the_first_step_and_zeroes_the_state_it_made():
    """``torch.optim``'s optimizers make their moments at the first step;
    a skipped first step leaves them zero, as they would have been made."""
    aug, samples = _setup()
    batches = _batches(samples)
    state = _state(aug)
    params = [p.detach().clone() for p in state.model.parameters()]
    m = wrap_step_with_guard(make_train_step())(state, poison_batch(batches[0]))
    assert int(m["skipped"]) == 1
    for p, q in zip(state.model.parameters(), params):
        assert torch.equal(p, q)
    for s in state.optimizer.state.values():
        for v in s.values():
            if torch.is_tensor(v):
                assert torch.count_nonzero(v) == 0


def test_guard_catches_an_overflowed_optimizer_moment():
    """A finite loss and finite parameters with an Inf moment: the guard
    reads the optimizer state too, so the step is skipped."""
    aug, samples = _setup()
    batches = _batches(samples)
    state = _state(aug)
    raw = make_train_step()
    raw(state, batches[0])

    def blow_moments(state, batch):
        m = raw(state, batch)
        with torch.no_grad():
            for s in state.optimizer.state.values():
                s["exp_avg_sq"].mul_(float("inf"))
        return m

    before = _snapshot(state)
    m = wrap_step_with_guard(blow_moments)(state, batches[1])
    assert int(m["skipped"]) == 1 and _finite(state)
    _assert_bits(before, _snapshot(state))


def test_an_all_skipped_epoch_reports_nan_and_the_step_count_reverts():
    aug, samples = _setup()
    batches = _batches(samples)
    state = _state(aug)
    step = wrap_step_with_guard(make_train_step())
    step(state, batches[3])  # the optimizer's state made
    before = _snapshot(state)
    loss, tasks = train_epoch(step, state, [poison_batch(b) for b in batches[:3]])
    assert np.isnan(loss) and np.isnan(tasks).all() and state.step == 1
    _assert_bits(before, _snapshot(state))
    from hydragnn_tpu_torch.train.checkpoint import Checkpoint

    assert Checkpoint("nan_run", path="/nonexistent")(state, 0, loss) is False
    loss2, _ = train_epoch(step, state, [poison_batch(batches[0]), batches[1]])
    assert np.isfinite(loss2) and state.step == 2


def test_skip_tracker_defers_reads_and_trips():
    t = SkipTracker(max_consecutive=3, lag=2)
    t.push(torch.tensor(1))
    t.push(torch.tensor(1))
    assert t.total == 0
    t.push(torch.tensor(1))
    assert t.total == 1 and t.consecutive == 1
    with pytest.raises(DivergenceDetected, match="consecutive non-finite"):
        t.finish()
    t2 = SkipTracker(max_consecutive=3, lag=0)
    t2.push(torch.tensor([1, 1, 0, 1]))
    assert (t2.total, t2.consecutive) == (3, 1)


# -- rollback and abort ------------------------------------------------------


def _loop(tmp_path, num_epoch=3, n_train=16):
    aug, samples = _setup()
    nn = copy.deepcopy(aug["NeuralNetwork"])
    nn["Training"]["num_epoch"] = num_epoch
    nn["Training"]["resilience"]["nonfinite_guard"] = True
    loaders = (GraphLoader(samples[:n_train], 4),
               GraphLoader(samples[n_train:n_train + 8], 4, drop_last=False),
               GraphLoader(samples[n_train + 8:n_train + 16], 4, drop_last=False))
    return nn, _state(aug), loaders, str(tmp_path)


def test_divergence_rolls_back_to_the_last_good_checkpoint_and_recovers(tmp_path):
    nn, state, loaders, path = _loop(tmp_path)
    res = Resilience.from_config(nn["Training"])
    res.max_consecutive_skips, res.checkpoint_every_epoch = 2, True
    res.chaos = FaultPlan.parse('[{"fault": "nan_batch", "epoch": 1, "times": 4}]')
    out = train_validate_test(state, *loaders, nn, "rollback_run", path=path, resilience=res)
    assert res.rollbacks == 1 and _finite(out) and out.step == 12
    base = float(nn["Training"]["Optimizer"]["learning_rate"])
    np.testing.assert_allclose(get_learning_rate(out.optimizer), base * 0.5, rtol=1e-12)


def test_divergence_aborts_after_max_rollbacks_and_the_checkpoint_stays_good(tmp_path):
    nn, state, loaders, path = _loop(tmp_path)
    res = Resilience.from_config(nn["Training"])
    res.max_consecutive_skips, res.max_rollbacks, res.checkpoint_every_epoch = 2, 1, True
    res.chaos = FaultPlan.parse('[{"fault": "nan_batch", "epoch": 1, "times": -1}]')
    with pytest.raises(TrainingDivergedError, match="consecutive non-finite"):
        train_validate_test(state, *loaders, nn, "abort_run", path=path, resilience=res)
    _, fresh, _, _ = _loop(tmp_path)
    assert load_checkpoint(fresh, "abort_run", path=path)["epoch"] == 0 and _finite(fresh)


def test_the_skip_streak_persists_across_epochs(tmp_path):
    nn, state, loaders, path = _loop(tmp_path)
    res = Resilience.from_config(nn["Training"])
    res.max_consecutive_skips, res.max_rollbacks, res.checkpoint_every_epoch = 6, 0, True
    res.chaos = FaultPlan.parse('[{"fault": "nan_batch", "epoch": 1, "times": -1},'
                                ' {"fault": "nan_batch", "epoch": 2, "times": -1}]')
    with pytest.raises(TrainingDivergedError):
        train_validate_test(state, *loaders, nn, "streak_run", path=path, resilience=res)


def test_the_rollback_lr_cut_compounds(tmp_path):
    from hydragnn_tpu_torch.train.loop import _rollback_state

    nn, state, _, path = _loop(tmp_path)
    res = Resilience.from_config(nn["Training"])
    save_checkpoint(state, "compound_run", 0, path=path)
    base = get_learning_rate(state.optimizer)
    for k, expect in ((1, 0.5), (2, 0.25)):
        _rollback_state(state, "compound_run", path, res, k, "test", 0)
        np.testing.assert_allclose(get_learning_rate(state.optimizer), base * expect,
                                   rtol=1e-12)


def test_divergence_without_a_checkpoint_aborts_with_guidance(tmp_path):
    nn, state, loaders, path = _loop(tmp_path, num_epoch=2)
    res = Resilience.from_config(nn["Training"])
    res.max_consecutive_skips = 2
    res.chaos = FaultPlan.parse('[{"fault": "nan_batch", "epoch": 0, "times": -1}]')
    with pytest.raises(TrainingDivergedError, match="checkpoint_every_epoch"):
        train_validate_test(state, *loaders, nn, "no_ckpt_run", path=path, resilience=res)


# -- preemption and exact resume ---------------------------------------------


def _small_cfg(num_epoch=2):
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Training"].update(num_epoch=num_epoch, batch_size=4)
    cfg["Dataset"]["name"] = "resilience_ci"
    return cfg


_RESUME = textwrap.dedent("""
    import copy, json, sys
    import numpy as np
    sys.path.insert(0, {repo!r})
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.datasets.synthetic import deterministic_graph_data
    cfg = json.loads({cfg!r})
    state, _, _ = run_training(cfg, samples=deterministic_graph_data(
        number_configurations=24, seed=11), device="cpu", path={path!r})
    np.savez({out!r}, step=state.step, **{{k: v.numpy() for k, v in
                                           state.model.state_dict().items()}})
""")


def test_sigterm_mid_epoch_resume_in_a_fresh_process_bit_matches(tmp_path, monkeypatch):
    """The fault plan SIGTERMs the run at epoch 0 dispatch 1; the loop
    checkpoints at the next boundary with the loader's position, no final
    checkpoint overwrites it, and a continued run in a fresh process trains
    exactly the batches not seen: its fp32 state equals the uninterrupted
    run's bit for bit."""
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.config import get_log_name_config

    def samples():
        return deterministic_graph_data(number_configurations=24, seed=11)

    whole, _, _ = run_training(_small_cfg(), samples=samples(), device="cpu",
                               path=str(tmp_path / "a"))
    monkeypatch.setenv("HYDRAGNN_FAULT_PLAN",
                       '[{"fault": "sigterm", "epoch": 0, "dispatch": 1}]')
    cut, _, aug = run_training(_small_cfg(), samples=samples(), device="cpu",
                               path=str(tmp_path / "b"))
    monkeypatch.delenv("HYDRAGNN_FAULT_PLAN")
    metas = glob.glob(str(tmp_path / "b" / get_log_name_config(aug) / "checkpoints"
                          / "*.meta.json"))
    assert len(metas) == 1, metas
    meta = json.load(open(metas[0]))
    assert meta["mid_epoch"] and meta["epoch"] == 0 and meta["raw_batches_done"] == 2
    assert cut.step == 2 < whole.step
    cfg = _small_cfg()
    cfg["NeuralNetwork"]["Training"]["continue"] = 1
    out = str(tmp_path / "resumed.npz")
    subprocess.run([sys.executable, "-c", _RESUME.format(
        repo=REPO, cfg=json.dumps(cfg), path=str(tmp_path / "b"), out=out)],
        check=True, timeout=300, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"})
    got = np.load(out)
    assert int(got["step"]) == whole.step
    for k, v in whole.model.state_dict().items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_resume_restarts_the_epoch_when_the_shuffle_seed_changed(tmp_path):
    nn, state, loaders, path = _loop(tmp_path, num_epoch=1)
    meta = {"mid_epoch": True, "epoch": 0, "raw_batches_done": 2, "steps_per_dispatch": 1,
            "n_dev": 1, "shuffle_seed": 3}
    out = train_validate_test(state, *loaders, nn, "seed_mismatch", path=path,
                              resume_meta=dict(meta))
    assert out.step == 4
    nn2, state2, loaders2, _ = _loop(tmp_path, num_epoch=1)
    out2 = train_validate_test(state2, *loaders2, nn2, "seed_match", path=path,
                               resume_meta=dict(meta, shuffle_seed=0))
    assert out2.step == 2


@pytest.mark.parametrize("k,group", [(1, 1), (4, 1), (4, 2)])
def test_the_loader_resume_point_matches_the_jax_loaders(k, group):
    """``set_resume_point`` drops the trained prefix of the final plan
    (after the group and K-block reorder), as the JAX loader does."""
    from hydragnn_tpu.datasets import deterministic_graph_data as jax_data
    from hydragnn_tpu.graphs.batching import GraphLoader as JaxLoader

    import torch_port_util as tpu

    samples = jax_data(number_configurations=80, seed=4)
    port = GraphLoader(tpu.port_samples(samples), 4, shuffle=True, seed=2, buckets=3)
    jax = JaxLoader(samples, 4, shuffle=True, seed=2, buckets=3)
    for ld in (port, jax):
        ld.set_epoch(1)
        ld.set_group(group)
        ld.set_superstep(k)
        ld.set_resume_point(4 * group)
    got, want = port.batch_plan(), jax.batch_plan()
    assert [c.tolist() for c, _ in got] == [c.tolist() for c, _ in want]
    assert [p.as_tuple() for _, p in got] == [p.as_tuple() for _, p in want]
    assert len(port.batch_plan()) == len(got) + 4 * group  # one-shot


# -- checkpoints -------------------------------------------------------------


def test_a_corrupted_latest_falls_back_to_the_previous_epoch(tmp_path):
    nn, state, _, path = _loop(tmp_path)
    save_checkpoint(state, "corrupt_run", 0, path=path)
    with torch.no_grad():
        next(state.model.parameters()).add_(1.0)
    save_checkpoint(state, "corrupt_run", 1, path=path)
    plan = FaultPlan.parse('[{"fault": "corrupt_latest", "epoch": 1}]')
    plan.on_epoch_end(1, "corrupt_run", path)
    assert plan.log == [("corrupt_latest", 1, None)]
    _, fresh, _, _ = _loop(tmp_path)
    with pytest.warns(UserWarning, match="fallback"):
        meta = load_checkpoint(fresh, "corrupt_run", path=path)
    assert meta["epoch"] == 0
    from hydragnn_tpu_torch.train.checkpoint import CheckpointCorruptError

    with pytest.raises((CheckpointCorruptError, RuntimeError, OSError, ValueError)):
        load_checkpoint(fresh, "corrupt_run", path=path, epoch=1)
    assert os.path.getsize(corrupt_checkpoint(
        os.path.join(path, "corrupt_run", "checkpoints", "epoch_0.pt"))) > 0


# -- the watchdog and the fault plan ----------------------------------------


def test_the_stop_poll_is_scheduled_by_time_under_a_group(monkeypatch):
    """Under a process group the ranks poll at an epoch's first dispatch,
    then ``POLL_S`` ahead at the slowest rank's pace (the agreed maximum),
    at every epoch end, and at every dispatch with ``poll_every`` 1; a
    request seen at a poll stops the run (the group faked: world 2, the
    all-reduce the identity on this rank's values)."""
    import hydragnn_tpu_torch.parallel.comm as comm

    monkeypatch.setattr(comm, "world_of", lambda group=None: 2)
    polls = []

    def agree(flag, value=0.0):
        polls.append(value)
        return bool(flag), float(value)

    now = {"t": 0.0}
    monkeypatch.setattr(time, "perf_counter", lambda: now["t"])
    res = Resilience()
    res.POLL_S = 0.05
    monkeypatch.setattr(res, "agree", agree)
    polled = []
    for d in range(40):
        n = len(polls)
        now["t"] = d * 0.01  # a dispatch every 10 ms
        assert not res.stop_requested(d)
        if len(polls) > n:
            polled.append(d)
    # the first dispatch, the default stride (8), then 0.05 s at 10 ms per
    # dispatch: every 5th
    assert polled[:4] == [0, 8, 13, 18], polled
    assert not res.stop_requested(None) and len(polls) == len(polled) + 1
    every = Resilience(poll_every=1)
    monkeypatch.setattr(every, "agree", agree)
    n = len(polls)
    for d in range(6):
        every.stop_requested(d)
    assert len(polls) == n + 6
    from hydragnn_tpu_torch.resilience import PreemptionHandler

    res.preempt = PreemptionHandler()
    res.preempt.request()
    assert not res.stop_requested(polled[-1] + 1)  # between polls
    assert res.stop_requested(res._next_poll)


def test_the_watchdog_fires_once_on_a_hang_and_stays_quiet_otherwise():
    fired = []
    wd = Watchdog(0.05, on_hang=fired.append)
    with wd.guard("fast"):
        pass
    time.sleep(0.1)
    assert wd.fired == 0
    with pytest.warns(UserWarning, match="slow"):
        with wd.guard("slow"):
            time.sleep(0.3)
    assert wd.fired == 1 and fired == ["slow"] and wd.events == ["slow"]
    assert Watchdog(0).timeout_s == 0.0


def test_a_chaos_hang_trips_the_dispatch_watchdog_in_train_epoch():
    aug, samples = _setup()
    batches = _batches(samples)
    res = Resilience.from_config({"resilience": {"watchdog_dispatch_s": 0.05}})
    res.chaos = FaultPlan.parse('[{"fault": "hang", "epoch": 0, "dispatch": 2, '
                                '"seconds": 0.3}]')
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        train_epoch(make_train_step(), _state(aug), batches, resilience=res)
    assert res.dispatch_watchdog.fired == 1 and res.hung_dispatches == 1
    assert res.dispatch_watchdog.events == ["dispatch 2"]
    assert res.chaos.log == [("hang", 0, 2)]


PLAN = ('[{"fault": "nan_batch", "epoch": 0, "dispatch": 3},'
        ' {"fault": "sigterm", "epoch": 1, "dispatch": 5},'
        ' {"fault": "hang", "epoch": 0, "dispatch": 2, "seconds": 1.5},'
        ' {"fault": "corrupt_latest", "epoch": 0, "times": -1},'
        ' {"fault": "device_loss", "epoch": 1, "device": 3, "count": 2},'
        ' {"fault": "mesh_shrink", "epoch": 1, "dispatch": 1, "to": 2},'
        ' {"fault": "double_fault", "inner": {"fault": "sigterm"}}]')


def test_fault_plan_parsing_matches_the_jax_package(tmp_path, monkeypatch):
    import dataclasses

    from hydragnn_tpu.resilience.chaos import FaultPlan as JaxPlan

    got = [dataclasses.asdict(e) for e in FaultPlan.parse(PLAN).events]
    assert got == [dataclasses.asdict(e) for e in JaxPlan.parse(PLAN).events]
    f = tmp_path / "plan.json"
    f.write_text(PLAN)
    monkeypatch.setenv("HYDRAGNN_FAULT_PLAN", f"@{f}")
    assert [dataclasses.asdict(e) for e in FaultPlan.from_env().events] == got
    with pytest.raises(ValueError, match="not one of"):
        FaultPlan.parse('[{"fault": "meteor"}]')
    with pytest.raises(ValueError, match="inner"):
        FaultPlan.parse('[{"fault": "double_fault", "inner": {"fault": "hang"}}]')
    for fleet in ("replica_kill", "replica_slow", "rollout_during_load"):
        with pytest.raises(NotImplementedError, match="item 10"):
            FaultPlan.parse(f'{{"fault": "{fleet}"}}')


def test_chaos_dead_shard_and_slow_peer_reach_the_live_store_servers():
    """The store's live-server registry: ``dead_shard`` closes the
    ``peer``-th live server, then ``slow_peer`` delays the one now at that
    index (the registry holds the live ones); a plan naming a server that
    is not there is inert. No server thread outlives the
    test."""
    from hydragnn_tpu_torch.datasets.sharded import ShardServer, live_servers

    # the drills act on the servers, not on what they serve
    servers = [ShardServer(None, 0, 8, host="127.0.0.1") for _ in range(2)]
    try:
        assert live_servers()[-2:] == servers
        base = len(live_servers()) - 2
        plan = FaultPlan.parse(f'[{{"fault": "dead_shard", "dispatch": 0, "peer": {base}}},'
                               f' {{"fault": "slow_peer", "dispatch": 1, "peer": {base},'
                               ' "seconds": 0.25}, {"fault": "dead_shard", "dispatch": 2, '
                               '"peer": 99}]')
        for i in range(3):
            assert plan.on_dispatch(0, i, "batch") == "batch"
        assert servers[0].closed and servers[0] not in live_servers()
        assert servers[1]._test_delay_s == 0.25 and servers[1] in live_servers()
        assert [e[0] for e in plan.log] == ["dead_shard", "slow_peer", "dead_shard"]
    finally:
        for s in servers:
            s.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("ShardServer")
                and t.is_alive() and not t.daemon]
