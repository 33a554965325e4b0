"""The port's elastic layer and supersteps at world > 1: the elastic
controller (``hydragnn_tpu_torch/resilience/elastic.py``), the in-process
recovery driven through ``run_training``, the seeded chaos campaign
(``resilience/campaign.py``), and K-step blocks over data-parallel groups
(``GraphLoader.set_group`` with ``set_superstep``), mirroring the JAX
package's ``tests/test_remesh.py`` and ``tests/test_elastic.py:530-800``.

The multi-rank runs are ``gloo`` worker processes
(``torch_parallel_pool.py``) on the tier-1 canary GIN
(``tests/test_config.py``). Tolerances, with their reasons:

* K = 4 blocks on 2 ranks against K = 1 on 2 ranks over the same plan:
  equal bit for bit (the same steps in the same order);
* against the JAX package's K = 1 epochs on a 2-device mesh (the
  reference's own K > 1 and resharded gates fail on the seed): the plan
  (every batch's samples and bucket) equal; the epoch losses and the
  parameters after two SGD epochs (16 steps, lr 0.1) within
  ``SPREAD_FACTOR`` times the JAX package's own spread (its largest move
  of a loss, of a parameter entry) under a ``NOISE`` perturbation of its
  initial parameters, measured in the test: these
  steps amplify rounding (the canary GIN's batch norms on 4-graph batches),
  and the port's sums associate otherwise than XLA's;
* a 3 -> 2 rank ``device_loss`` in the last epoch against the uninterrupted
  3-rank run: the campaign's invariants (``check_invariants``): the same
  update count (zero samples lost or trained twice) and every state tensor
  within rtol 2e-2, atol ``lr`` x the updates after the shrink (the
  survivors' gradient sums associate otherwise and one Adam update turns a
  rounding difference into an O(lr) move);
* an in-process recovery without a topology change: bit for bit.
"""

import copy
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.step import TrainState as JaxTrainState
from hydragnn_tpu_torch.convert import port_arrays
from hydragnn_tpu_torch.graphs.batching import GraphLoader
from hydragnn_tpu_torch.resilience import (ElasticController, ElasticRecoveryError, Fault,
                                           Resilience, Watchdog, train_elastic)
from hydragnn_tpu_torch.resilience.campaign import (ScheduleOutcome, check_invariants,
                                                    nondaemon_thread_count,
                                                    random_fault_schedule, run_campaign,
                                                    split_plan)
from hydragnn_tpu_torch.resilience.elastic import deliver_fault
from test_config import CI_CONFIG
from test_torch_train_step import Setup
from torch_parallel_pool import WorkerPool

# the reference's own spread: a relative perturbation of its initial
# parameters at fp32's rounding scale, and the bound's multiple of it
NOISE = 1e-7
SPREAD_FACTOR = 10.0
SGD = {"type": "SGD", "learning_rate": 0.1}


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(world):
        if world not in made:
            made[world] = WorkerPool(tmp_path_factory.mktemp(f"el{world}"), world=world)
        return made[world]

    yield get
    for p in made.values():
        p.close()


# -- the controller ----------------------------------------------------------


def test_controller_survivor_bookkeeping_and_policies():
    ctl = ElasticController(ranks=range(4))
    assert "lost original ranks [3]" in ctl.apply(Fault(kind="device_loss"))
    assert ctl.survivors() == [0, 1, 2]
    assert "[1, 2]" in ctl.apply(Fault(kind="device_loss", device=2, count=2))
    assert ctl.survivors() == [0] and ctl.lost_indices() == (1, 2, 3)
    # a lost rank named again: the walk goes down to the last one alive
    with pytest.raises(ElasticRecoveryError, match="no survivor"):
        ctl.apply(Fault(kind="device_loss", device=3))
    shrink = ElasticController(ranks=range(4))
    shrink.bind_ranks(range(8))  # the first bind wins
    shrink.apply(Fault(kind="mesh_shrink", to=2))
    assert shrink.survivors() == [0, 1]
    assert shrink.plan_remesh("data")[0] == "remesh"
    for route in ("tensor", "pipeline", "halo", "edge", "single"):
        assert shrink.plan_remesh(route)[0] == "restart_fallback"
    assert ElasticController(ranks=range(2)).plan_remesh("pipeline")[0] == "resume"
    zero = ElasticController(ranks=range(3))
    zero.apply(Fault(kind="device_loss", device=0))
    assert zero.plan_remesh("data") == ("restart_fallback", "rank 0 hosts the rendezvous "
                                        "store the survivors re-form on")
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault(kind="meteor")


def test_signal_drains_reset_clears_and_a_hung_dispatch_escalates(capsys):
    res = Resilience.from_config({})
    ctl = ElasticController(ranks=range(2))
    ctl.attach(res)
    assert res.controller is ctl and not res.preempt_requested()
    res.note_hung_dispatch()
    assert res.hung_dispatches == 1 and res.preempt_requested() and ctl.state == "draining"
    assert [f.kind for f in ctl.take_pending()] == ["hung_dispatch"]
    res.preempted = True
    res.reset_for_resume()
    assert not res.preempt_requested() and not res.preempted
    assert deliver_fault("device_loss") is False
    assert "no active ElasticController" in capsys.readouterr().err


def test_the_driver_resumes_falls_back_and_spends_its_budget():
    """``train_elastic``'s state machine over a stand-in segment: a drain
    with no fault resumes in place; a pipeline's rank loss falls back to a
    restart; a lost rank leaves; the budget runs out."""
    calls = []

    def segment(res, outcomes):
        def run(meta):
            calls.append(meta)
            res.preempted = outcomes.pop(0)
            return "state"
        return run

    res = Resilience.from_config({})
    state, ctl = train_elastic(segment(res, [True, False]),
                               lambda s, g, m: {"mid_epoch": True, "epoch": 0}, res)
    assert ctl.state == "done" and ctl.recoveries == 1 and calls[-1]["mid_epoch"]
    assert ctl.recovery_log[0]["mode"] == "resume"

    res = Resilience.from_config({})
    fallback = ElasticController()
    fallback.signal(Fault(kind="device_loss"))
    _, ctl = train_elastic(segment(res, [True]), lambda s, g, m: {}, res, controller=fallback,
                           route="pipeline", world=2)
    assert ctl.state == "restart_fallback"

    res = Resilience.from_config({})
    lost = ElasticController()
    lost.signal(Fault(kind="device_loss"))
    _, ctl = train_elastic(segment(res, [True]), lambda s, g, m: None, res, controller=lost,
                           world=2)
    assert ctl.state == "lost"

    res = Resilience.from_config({})
    spent = ElasticController(max_recoveries=1)
    with pytest.raises(ElasticRecoveryError, match="max_recoveries"):
        train_elastic(segment(res, [True, True]), lambda s, g, m: {}, res, controller=spent)


def test_concurrent_watchdog_guards_fire_independently():
    wd = Watchdog(0.05)
    hits = []

    def region(i, hold):
        with wd.guard(f"g{i}", on_expire=lambda: hits.append(i)):
            time.sleep(hold)

    threads = [threading.Thread(target=region, args=(i, 0.25 if i % 2 else 0.0))
               for i in range(4)]
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert sorted(hits) == [1, 3] and wd.fired == 2


# -- the campaign ------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_campaign_schedules_are_the_jax_schedulers(seed):
    from hydragnn_tpu.resilience.campaign import random_fault_schedule as jax_schedule

    kw = dict(epochs=3, dispatches=4, n_devices=4, n_peers=2)
    assert random_fault_schedule(seed, **kw) == jax_schedule(seed, **kw)
    ref, every = split_plan(random_fault_schedule(seed, **kw))
    assert all(e["fault"] == "nan_batch" for e in ref) and len(every) >= len(ref)


def _campaign_cfg():
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Training"].update(num_epoch=2, batch_size=4)
    cfg["NeuralNetwork"]["Training"]["resilience"] = {"nonfinite_guard": True,
                                                      "elastic": True}
    cfg["Dataset"]["name"] = "campaign_ci"
    return cfg


def test_a_seeded_campaign_recovers_in_process_bit_exact(tmp_path, monkeypatch):
    """One seeded schedule on one rank (no topology fault: ``nan_batch``,
    ``hang`` and ``sigterm``): the faulted run, recovered in process by the
    elastic driver, against the reference run that replays only the
    perturbing faults, held to the four invariants."""
    import json

    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.datasets.synthetic import deterministic_graph_data

    def run(events, where):
        monkeypatch.setenv("HYDRAGNN_FAULT_PLAN", json.dumps(events or []))
        state, model, _ = run_training(_campaign_cfg(), samples=deterministic_graph_data(
            number_configurations=24, seed=11), device="cpu", path=str(tmp_path / where))
        monkeypatch.delenv("HYDRAGNN_FAULT_PLAN")
        full = {f"model/{k}": v.numpy().copy() for k, v in model.state_dict().items()}
        for i, per in state.optimizer.state_dict()["state"].items():
            full.update({f"opt/{i}/{k}": v.numpy().copy() for k, v in per.items()})
        return state, full

    def run_schedule(seed, events):
        ref_events, every = split_plan(events)
        before = nondaemon_thread_count()
        ref_state, ref = run(ref_events, f"ref{seed}")
        state, got = run(every, f"run{seed}")
        return ScheduleOutcome(seed=seed, events=events, ref_state=ref, state=got,
                               ref_step=ref_state.step, step=state.step,
                               controller=state.resilience.controller, lr=0.02,
                               mesh_changed=False, threads_before=before,
                               threads_after=nondaemon_thread_count())

    report = run_campaign([3], run_schedule, epochs=2, dispatches=3, n_devices=1,
                          kinds=("nan_batch", "hang", "sigterm"), max_faults=3)
    assert report["passed"], report["violations"]
    kinds = {e["fault"] for e in report["schedules"][0]["events"]}
    assert "sigterm" in kinds and report["schedules"][0]["recoveries"] >= 1, report


def test_invariants_flag_lost_updates_and_drift():
    ref = {"w": np.ones(3, np.float32)}
    ok = ScheduleOutcome(seed=0, events=[], ref_state=ref, state=dict(ref), ref_step=4,
                         step=4, controller=None, lr=0.01, mesh_changed=False)
    assert check_invariants(ok) == []
    assert "lost or duplicated" in check_invariants(dataclasses.replace(ok, step=3))[0]
    drift = dataclasses.replace(ok, state={"w": ref["w"] + 1e-6})
    assert "bit-exact" in check_invariants(drift)[0]
    assert check_invariants(dataclasses.replace(drift, mesh_changed=True)) == []


# -- supersteps over data-parallel groups -------------------------------------


def _k_setup():
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Training"].update(batch_size=4, num_epoch=2, Optimizer=SGD)
    return cfg, Setup(cfg, n_samples=96)


def test_supersteps_on_two_ranks_equal_k1_and_the_jax_k1_mesh_epochs(pools, tmp_path):
    from hydragnn_tpu.datasets import deterministic_graph_data as jax_data
    from hydragnn_tpu.graphs.batching import GraphLoader as JaxLoader
    from hydragnn_tpu.parallel import make_mesh, make_parallel_train_step, shard_state
    from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jax_loading
    from hydragnn_tpu.train.loop import train_epoch as jax_train_epoch

    cfg, s = _k_setup()
    jl = jax_loading(copy.deepcopy(cfg), samples=jax_data(number_configurations=96, seed=7))
    splits = {k: tpu.port_samples(ld.samples) for k, ld in zip(("train", "val", "test"), jl)}
    model = s.port_model()
    base = {"aug": s.aug, "opt": SGD, "samples": splits, "batch_size": 4, "buckets": 3,
            "path": str(tmp_path), "state": {k: v.numpy() for k, v in
                                             model.state_dict().items()}}
    nn4 = copy.deepcopy(s.aug["NeuralNetwork"])
    nn4["Training"]["steps_per_dispatch"] = 4
    nn1 = copy.deepcopy(s.aug["NeuralNetwork"])
    k4 = pools(2).run("train_loop", {**base, "config_nn": nn4})
    k1 = pools(2).run("train_loop", {**base, "config_nn": nn1, "plan_k": 4})
    for a, b in zip(k4, k1):
        assert a["step"] == b["step"] and a["history"][0]["train_loss"] == \
            b["history"][0]["train_loss"]
        for name in a["state"]:
            np.testing.assert_array_equal(a["state"][name], b["state"][name], err_msg=name)

    mesh = make_mesh(devices=jax.devices()[:2])
    opt = jax_select_optimizer(SGD)
    step = make_parallel_train_step(s.jmodel, opt, mesh)
    loader = JaxLoader(jl[0].samples, 4, shuffle=True, seed=0, buckets=3)
    port = GraphLoader(splits["train"], 4, shuffle=True, seed=0, buckets=3)
    for ld in (loader, port):
        ld.set_group(2)
        ld.set_superstep(4)
        ld.set_epoch(1)
    assert [(c.tolist(), p.as_tuple()) for c, p in port.batch_plan()] == \
        [(c.tolist(), p.as_tuple()) for c, p in loader.batch_plan()]

    def jax_run(noise: float):
        """The JAX package's two epochs from its initial parameters, each
        scaled by 1 + noise x N(0, 1) (a fixed draw)."""
        rng = np.random.default_rng(0)
        params = jax.tree.map(lambda p: jnp.asarray(np.asarray(p) * (
            1 + noise * rng.standard_normal(np.shape(p))).astype(np.float32)),
            s.jstate.params)
        state = shard_state(JaxTrainState(params=params, batch_stats=jax.tree.map(
            jnp.array, s.jstate.batch_stats), opt_state=opt.init(params),
            step=jnp.asarray(0)), mesh)
        losses = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            state, loss, _ = jax_train_epoch(step, state, loader, mesh=mesh)
            losses.append(loss)
        return state, np.asarray(losses), port_arrays(tpu.numpy_tree(state.params))

    state, losses, params = jax_run(0.0)
    _, spread_losses, spread_params = jax_run(NOISE)
    # the spread of one draw over the whole run: the largest move of any
    # loss, and of any parameter entry
    loss_bound = SPREAD_FACTOR * np.abs(spread_losses - losses).max() + 1e-7
    got = np.abs(np.asarray([h["train_loss"] for h in k4[0]["history"]]) - losses).max()
    assert got <= loss_bound, (got, loss_bound)
    param_bound = SPREAD_FACTOR * max(np.abs(spread_params[n] - w).max()
                                      for n, w in params.items()) + 1e-6
    for name, w in params.items():
        assert np.abs(k4[0]["state"][name] - w).max() <= param_bound, name
    assert k4[0]["step"] == int(np.asarray(state.step))


# -- the elastic re-mesh across processes -------------------------------------


def _elastic_cfg():
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Training"].update(num_epoch=2, batch_size=4)
    cfg["NeuralNetwork"]["Training"]["resilience"] = {"elastic": True}
    cfg["Dataset"]["name"] = "elastic_ci"
    return cfg


def test_device_loss_3_to_2_ranks_loses_no_sample_and_ends_allclose(pools, tmp_path):
    """Rank 2 is lost at epoch 1 dispatch 1 of a 3-rank data-parallel run:
    every rank drains at one boundary and checkpoints, rank 2 leaves, ranks
    0 and 1 form a group of 2 in process and finish the epoch on the saved
    3-wide update grid. The last test of the module: its pool's group is
    the survivors'."""
    from hydragnn_tpu_torch.datasets.synthetic import deterministic_graph_data

    samples = deterministic_graph_data(number_configurations=60, seed=13)
    pool = pools(3)
    whole = pool.run("run_training", {"config": _elastic_cfg(), "samples": samples,
                                      "path": str(tmp_path / "whole"), "shared_path": True})
    cut = pool.run("run_training", {
        "config": _elastic_cfg(), "samples": samples, "path": str(tmp_path / "cut"),
        "shared_path": True,
        "env": {"HYDRAGNN_FAULT_PLAN": '[{"fault": "device_loss", "epoch": 1, '
                                       '"dispatch": 1, "device": 2}]'}})
    assert cut[2]["controller"]["state"] == "lost"
    lr = float(CI_CONFIG["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"])
    per_epoch = whole[0]["step"] // 2
    for r in (0, 1):
        ctl = cut[r]["controller"]
        assert ctl["state"] == "done" and ctl["recoveries"] == 1
        entry = ctl["log"][0]
        assert entry["mode"] == "remesh" and entry["lost_indices"] == [2]
        # the fault at dispatch 1: two dispatches of three batches trained
        assert entry["raw_batches_done"] == 6 and entry["logical_n_dev"] == 3
        assert cut[r]["resume_mode"] == "elastic"
        state = {f"model/{k}": v for k, v in cut[r]["state"].items()}
        ref = {f"model/{k}": v for k, v in whole[r]["state"].items()}
        for i, per in whole[r]["optimizer"].items():
            ref.update({f"opt/{i}/{k}": v for k, v in per.items()})
            state.update({f"opt/{i}/{k}": v for k, v in cut[r]["optimizer"][i].items()})
        out = ScheduleOutcome(seed=0, events=[], ref_state=ref, state=state,
                              ref_step=whole[r]["step"], step=cut[r]["step"],
                              controller=None, lr=lr, mesh_changed=True,
                              approx_updates=per_epoch - 1)
        assert check_invariants(out) == []
    for name in cut[0]["state"]:
        np.testing.assert_array_equal(cut[0]["state"][name], cut[1]["state"][name])
