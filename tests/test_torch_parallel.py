"""The port's data-parallel layout (``hydragnn_tpu_torch/parallel/``: DDP,
FSDP, SyncBatchNorm, the rank grid, the grouped loaders, the data plane's
exchanges and ``run_training``) against the JAX package's 2-device mesh
steps, on the tier-1 canary GIN (``tests/test_config.py``: hidden 8, 2 conv
layers; hidden 128 for FSDP, whose rule shards only parameters of 2**14 or
more entries).

The port runs as 2 ``gloo`` worker processes (``torch_parallel_pool.py``),
each with its own batch; the JAX package as one SPMD step over a 2-device
mesh of the conftest's CPU devices, the two batches stacked.

Tolerances, with their reasons:

* losses and task losses: rtol 1e-5 (XLA and PyTorch sum in other orders);
* parameters after one SGD step (lr 0.1): atol 1e-6 + rtol 1e-5, so the
  gradient's rounding is held at 1e-5 of a step (SGD keeps the parameter
  deltas proportional to the gradients; Adam's first step amplifies a
  cancelling gradient's noise to a full step);
* running statistics: rtol 1e-5, atol 1e-6;
* the port's FSDP against its replicated step (2 AdamW steps): equal bit for
  bit, as the reduce-scatter of two ranks sums the same two values the
  all-reduce does.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.step import TrainState as JaxTrainState
from hydragnn_tpu_torch.convert import batch_from_numpy, port_arrays
from hydragnn_tpu_torch.graphs.graph import FIELDS
from test_config import CI_CONFIG
from test_torch_train_step import Setup
from torch_parallel_pool import WorkerPool

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
SGD = {"type": "SGD", "learning_rate": 0.1}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = WorkerPool(tmp_path_factory.mktemp("parallel"))
    yield p
    p.close()


def _config(hidden: int = 8, sync: bool = False) -> dict:
    cfg = copy.deepcopy(CI_CONFIG)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch["hidden_dim"] = hidden
    if sync:
        arch["SyncBatchNorm"] = True
    return cfg


_SETUPS: dict = {}


def _setup(hidden: int = 8, sync: bool = False) -> Setup:
    key = (hidden, sync)
    if key not in _SETUPS:
        _SETUPS[key] = Setup(_config(hidden, sync), n_samples=60)
    return _SETUPS[key]


def _arrays(batch) -> dict:
    """A batch (either package's, or a port ``GraphBatch``) as numpy fields."""
    return {f: (getattr(batch, f).numpy() if torch.is_tensor(getattr(batch, f))
                else np.asarray(getattr(batch, f))) for f in FIELDS}


def _port_inputs(s: Setup, rank_batches, opt=SGD, **kw) -> dict:
    model = s.port_model()
    return {"aug": s.aug, "opt": opt, "batches": rank_batches,
            "state": {k: v.numpy() for k, v in model.state_dict().items()}, **kw}


def _jax_step(s: Setup, group, mode="replicated", opt_cfg=SGD):
    """The JAX package's parallel train step (and eval step, on the
    pre-step state) over a 2-device mesh on the stacked ``group``."""
    from hydragnn_tpu.parallel import (make_mesh, make_parallel_eval_step,
                                       make_parallel_train_step, put_batch, shard_state,
                                       stack_device_batches)

    mesh = make_mesh(devices=jax.devices()[:2])
    opt = jax_select_optimizer(opt_cfg)
    params = jax.tree.map(jnp.array, s.jstate.params)
    state = JaxTrainState(params=params, batch_stats=jax.tree.map(jnp.array,
                                                                  s.jstate.batch_stats),
                          opt_state=opt.init(params), step=jnp.asarray(0))
    state = shard_state(state, mesh, param_mode=mode)
    sb = put_batch(stack_device_batches(list(group)), mesh)
    ev = make_parallel_eval_step(s.jmodel, mesh)(state, sb)
    new, metrics = make_parallel_train_step(s.jmodel, opt, mesh)(state, sb)
    return ({k: np.asarray(v) for k, v in metrics.items()},
            {k: np.asarray(v) for k, v in ev.items()},
            port_arrays(tpu.numpy_tree(new.params)),
            port_arrays(tpu.numpy_tree(new.batch_stats)))


def _assert_step_matches(outs, want, what):
    metrics, ev, params, stats = want
    for r, out in enumerate(outs):
        got = out["steps"][0]
        np.testing.assert_allclose(got["loss"], metrics["loss"], **LOSS_TOL,
                                   err_msg=f"{what} rank {r} loss")
        np.testing.assert_allclose(got["tasks_loss"], metrics["tasks_loss"], **LOSS_TOL,
                                   err_msg=f"{what} rank {r} tasks")
        assert float(got["num_graphs"]) == float(metrics["num_graphs"])
        for name, w in params.items():
            np.testing.assert_allclose(out["state"][name], w, **PARAM_TOL,
                                       err_msg=f"{what} rank {r} {name}")
        for name, w in stats.items():
            np.testing.assert_allclose(out["state"][name], w, **STAT_TOL,
                                       err_msg=f"{what} rank {r} {name}")
    # the ranks hold one state, bit for bit
    for name in outs[0]["state"]:
        np.testing.assert_array_equal(outs[0]["state"][name], outs[1]["state"][name])


def test_replicated_step_matches_the_jax_mesh(pool):
    """Two ranks, two batches: the graph-count-weighted loss, one SGD step's
    parameters and the merged running statistics equal the JAX mesh step's;
    the eval step's totals too."""
    s = _setup()
    b0, b1 = s.batches[0], s.batches[1]
    outs = pool.run("data_step", _port_inputs(s, [[_arrays(b0)], [_arrays(b1)]]))
    want = _jax_step(s, [b0, b1])
    _assert_step_matches(outs, want, "replicated")
    ev = want[1]
    for out in outs:
        for k in ("loss", "tasks_loss", "num_graphs", "head_sse"):
            np.testing.assert_allclose(out["eval"][k], ev[k], **LOSS_TOL, err_msg=k)
        np.testing.assert_array_equal(out["eval"]["head_count"], ev["head_count"])


def test_fill_batch_in_the_group_matches_the_jax_mesh(pool):
    """The epoch's last group short of a batch: rank 1 steps on the port's
    fill batch (``empty_like``, the JAX loop's ``_empty_like``), which
    carries no loss, gradient or statistic."""
    from hydragnn_tpu.train.loop import _empty_like
    from hydragnn_tpu_torch.graphs.batching import empty_like

    s = _setup()
    b0 = s.batches[0]
    fill = _arrays(empty_like(batch_from_numpy(b0)))
    jfill = _empty_like(b0)
    for f in FIELDS:
        np.testing.assert_array_equal(fill[f], np.asarray(getattr(jfill, f)), err_msg=f)
    outs = pool.run("data_step", _port_inputs(s, [[_arrays(b0)], [fill]]))
    want = _jax_step(s, [b0, jfill])
    _assert_step_matches(outs, want, "fill")
    assert float(outs[0]["steps"][0]["num_graphs"]) == float(np.asarray(b0.graph_mask).sum())


def test_fsdp_step_matches_the_jax_mesh_and_the_replicated_step(pool):
    """FSDP (hidden 128: the 128 x 128 weights reach 2**14 entries and
    shard): the SGD step equals the JAX package's ``fsdp`` mesh step, and
    two AdamW steps equal the port's replicated ones bit for bit, with each
    rank's optimizer holding only its shards."""
    from hydragnn_tpu.parallel.mesh import fsdp_param_specs, make_mesh
    from hydragnn_tpu_torch.parallel.mesh import fsdp_shard_dim

    s = _setup(hidden=128)
    b0, b1 = s.batches[:2]
    outs = pool.run("data_step", _port_inputs(s, [[_arrays(b0)], [_arrays(b1)]],
                                              mode="fsdp"))
    assert outs[0]["shards"], "no parameter reached the FSDP rule's size"
    _assert_step_matches(outs, _jax_step(s, [b0, b1], mode="fsdp"), "fsdp")
    # the rule: the port shards exactly the parameters the JAX package does
    specs = port_arrays(tpu.numpy_tree(jax.tree.map(
        lambda p: np.asarray(any(a is not None for a in p)),
        fsdp_param_specs(s.jstate.params, make_mesh(devices=jax.devices()[:2])),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    port = s.port_model()
    for name, p in port.named_parameters():
        assert (fsdp_shard_dim(p.shape, 2) is not None) == bool(specs[name]), name

    adam = {"type": "AdamW", "learning_rate": 1e-3}
    rb = [[_arrays(b0), _arrays(b1)], [_arrays(b1), _arrays(b0)]]
    fsdp = pool.run("data_step", _port_inputs(s, rb, opt=adam, mode="fsdp"))
    repl = pool.run("data_step", _port_inputs(s, rb, opt=adam))
    n_params = sum(p.numel() for p in port.parameters())
    for f, r in zip(fsdp, repl):
        assert f["optimizer_params"] < n_params == r["optimizer_params"]
        for step_f, step_r in zip(f["steps"], r["steps"]):
            np.testing.assert_array_equal(step_f["loss"], step_r["loss"])
        for name in r["state"]:
            np.testing.assert_array_equal(f["state"][name], r["state"][name], err_msg=name)


def test_fsdp_resume_matches_the_uninterrupted_run(pool, tmp_path):
    """``Training.continue`` under FSDP (hidden 128, AdamW):
    the checkpoint holds the one-device layout (the shards' moments
    all-gathered: equal bit for bit to the replicated run's checkpoint),
    and a fresh state that loads it before it shards, as ``run_training``
    resumes, takes the uninterrupted run's next steps bit for bit on both
    ranks (moments and step counts carried), and every rank's dropout
    generator continues from its own saved state."""
    s = _setup(hidden=128)
    b0, b1 = (_arrays(x) for x in s.batches[:2])
    adam = {"type": "AdamW", "learning_rate": 1e-3}
    outs = pool.run("fsdp_resume", _port_inputs(s, [[b0, b1, b0], [b1, b0, b1]], opt=adam,
                                                split=1, path=str(tmp_path)))
    for out in outs:
        assert out["shards"] > 0 and len(out["resumed_losses"]) == 2
        assert out["generator_resumed"]
        np.testing.assert_array_equal(out["resumed_losses"], out["losses"][1:])
        for name, w in out["state"].items():
            np.testing.assert_array_equal(out["resumed_state"][name], w, err_msg=name)
    saved = outs[0]["saved"]
    assert saved["fsdp"].keys() == saved["replicated"].keys() and saved["fsdp"]
    for i, per in saved["replicated"].items():
        assert per.keys() == saved["fsdp"][i].keys()
        for k, v in per.items():
            np.testing.assert_array_equal(saved["fsdp"][i][k], v, err_msg=f"{i} {k}")


@pytest.mark.parametrize("sync", [False, True], ids=["local_bn", "sync_bn"])
def test_batch_norm_statistics_match_the_jax_mesh(pool, sync):
    """Running statistics after a step: each rank's own batch merged over
    the ranks (binary weights), or with ``SyncBatchNorm`` the union batch's;
    the two differ, and each equals the JAX mesh step's."""
    s = _setup(sync=sync)
    b0, b1 = s.batches[0], s.batches[1]
    outs = pool.run("data_step", _port_inputs(s, [[_arrays(b0)], [_arrays(b1)]]))
    want = _jax_step(s, [b0, b1])
    _assert_step_matches(outs, want, f"sync={sync}")
    _STATS[sync] = outs[0]["state"]["feature_layers.0.var"]
    if len(_STATS) == 2:
        assert np.abs(_STATS[True] - _STATS[False]).max() > 1e-4


_STATS: dict = {}


def test_multibranch_grid_matches_the_jax_mesh(pool):
    """Two branches on a (2 branch x 1 data) grid: the port's
    ``branch_device_batches`` equal the JAX package's, each rank steps on its
    branch's batch, and the step equals the JAX (branch, data) mesh step."""
    from hydragnn_tpu.config import update_config as jax_update_config
    from hydragnn_tpu.models import create_model_config as jax_create_model_config
    from hydragnn_tpu.parallel import (make_mesh, make_parallel_train_step, put_batch,
                                       shard_state, stack_device_batches)
    from hydragnn_tpu.train import multibranch as jmb
    from hydragnn_tpu.train.step import create_train_state as jax_create_train_state
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.parallel.mesh import RankGrid
    from hydragnn_tpu_torch.train import multibranch as mb
    from test_multibranch import MULTIBRANCH_CONFIG_HEADS, make_two_datasets

    d0, d1 = make_two_datasets()
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Architecture"]["output_heads"] = copy.deepcopy(MULTIBRANCH_CONFIG_HEADS)
    jall = jmb.concat_multidataset({"bcc": tpu.jax_samples_copy(d0),
                                    "scaled": tpu.jax_samples_copy(d1)})
    jaug = jax_update_config(copy.deepcopy(cfg), jall)
    aug = update_config(copy.deepcopy(cfg), mb.concat_multidataset(
        {"bcc": tpu.port_samples(d0), "scaled": tpu.port_samples(d1)}))
    jloaders, _ = jmb.make_branch_loaders({"bcc": tpu.jax_samples_copy(d0),
                                           "scaled": tpu.jax_samples_copy(d1)}, batch_size=2)
    loaders, _ = mb.make_branch_loaders({"bcc": tpu.port_samples(d0),
                                         "scaled": tpu.port_samples(d1)}, batch_size=2)
    jstep = next(jmb.branch_device_batches(jloaders, 0, n_data=1))
    step = next(mb.branch_device_batches(loaders, 0, n_data=1))
    for a, b in zip(step, jstep):
        for f in FIELDS:
            np.testing.assert_array_equal(_arrays(a)[f], np.asarray(getattr(b, f)), err_msg=f)
    grid = [RankGrid(n_branch=2, n_data=1, rank=r) for r in range(2)]
    assert [(g.branch_index, g.data_index) for g in grid] == [(0, 0), (1, 0)]
    for g in grid:
        mine = next(mb.rank_batches(loaders, 0, g))
        np.testing.assert_array_equal(_arrays(mine)["x"], _arrays(step[g.rank])["x"])

    jmodel = jax_create_model_config(jaug)
    opt = jax_select_optimizer(SGD)
    jstate = jax_create_train_state(jmodel, opt, jstep[0])
    port = tpu.port_model_from_jax(aug, {"params": jstate.params,
                                         "batch_stats": jstate.batch_stats})
    outs = pool.run("data_step", {
        "aug": aug, "opt": SGD, "state": {k: v.numpy() for k, v in port.state_dict().items()},
        "batches": [[_arrays(step[g.rank])] for g in grid]})
    mesh = make_mesh(n_branch=2, n_data=1, devices=jax.devices()[:2])
    new, metrics = make_parallel_train_step(jmodel, opt, mesh)(
        shard_state(jstate, mesh, param_mode="branch"),
        put_batch(stack_device_batches(list(jstep)), mesh))
    want = ({k: np.asarray(v) for k, v in metrics.items()}, None,
            port_arrays(tpu.numpy_tree(new.params)), port_arrays(tpu.numpy_tree(new.batch_stats)))
    _assert_step_matches(outs, want, "multibranch")


def test_grouped_loaders_give_each_rank_its_slot_of_the_jax_groups():
    """``GraphLoader.set_group(2, slot)``: the two ranks' batches are the
    JAX loop's device groups (``_grouped(..., fill=True)`` over a loader
    with ``set_group(2)``), slot by slot, the trailing group's missing slot a
    fill batch; every rank takes the same number of steps."""
    from hydragnn_tpu.graphs.batching import GraphLoader as JaxLoader
    from hydragnn_tpu.train.loop import _grouped
    from hydragnn_tpu_torch.graphs.batching import GraphLoader

    from hydragnn_tpu.datasets import deterministic_graph_data

    samples = deterministic_graph_data(number_configurations=30, seed=3)
    # 30 samples: 8 batches of 4, four full groups; 26: 7, the last group
    # short of its second batch
    for src in (samples, samples[:26]):
        jax_loader = JaxLoader(tpu.jax_samples_copy(src), 4, shuffle=True, seed=5, buckets=3,
                               drop_last=False)
        jax_loader.set_group(2)
        jax_loader.set_epoch(1)
        want = list(_grouped(jax_loader, 2, None, fill=True, put=lambda b, mesh: b))
        assert len(want) == 4
        ranks = []
        for r in range(2):
            ld = GraphLoader(tpu.port_samples(src), 4, shuffle=True, seed=5, buckets=3,
                             drop_last=False)
            ld.set_group(2, r)
            ld.set_epoch(1)
            ranks.append(list(ld))
            assert len(ld) == len(want)
        for g, group in enumerate(want):
            for r in range(2):
                for f in FIELDS:
                    np.testing.assert_array_equal(_arrays(ranks[r][g])[f],
                                                  np.asarray(getattr(group, f))[r],
                                                  err_msg=f"group {g} rank {r} {f}")
    with pytest.raises(ValueError, match="slot"):
        GraphLoader(tpu.port_samples(samples), 4).set_group(2, 2)


def test_sharded_store_exchanges_its_peers(pool, tmp_path):
    """``ShardedStore`` without ``peers=``: the ranks exchange their
    addresses over the group and read the whole corpus, half of it from the
    other rank; the pad spec is the maximum over both shards; the energy
    regression sums both ranks' normal equations (the coefficients of one
    fit over every sample)."""
    from hydragnn_tpu_torch.datasets.packed import PackedWriter
    from hydragnn_tpu_torch.preprocess.energy_linear_regression import (
        fit_energy_linear_regression)

    from hydragnn_tpu.datasets import deterministic_graph_data

    samples = tpu.port_samples(deterministic_graph_data(number_configurations=12, seed=4))
    shards = []
    for r, (a, b) in enumerate([(0, 5), (5, 12)]):
        path = str(tmp_path / f"shard{r}.gpk")
        PackedWriter(samples[a:b], path)
        shards.append((path, a, b))
    rng = np.random.default_rng(0)
    reg = []
    for s in samples:
        s = copy.deepcopy(s)
        s.x = np.concatenate([rng.integers(1, 9, (s.num_nodes, 1)), s.x[:, 1:]], axis=1)
        s.energy_y = np.array([rng.normal()], np.float32)
        reg.append(s)
    torch.save([reg[:6], reg[6:]], tmp_path / "regression.pt")
    outs = pool.run("store", {"shards": shards, "host": "127.0.0.1",
                              "regression": str(tmp_path / "regression.pt")})
    for out in outs:
        assert len(out["x"]) == 12
        for s, x in zip(samples, out["x"]):
            np.testing.assert_array_equal(x, s.x)
        assert [p[2:] for p in out["peers"]] == [(0, 5), (5, 12)]
    assert outs[0]["peers"] == outs[1]["peers"]
    assert outs[0]["pad"] == outs[1]["pad"]
    assert outs[0]["pad"][0] >= max(s.num_nodes for s in samples) * 4
    np.testing.assert_allclose(outs[0]["coeff"], fit_energy_linear_regression(reg),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(outs[0]["coeff"], outs[1]["coeff"])


def _small_run_config() -> dict:
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Training"].update(num_epoch=2, batch_size=8)
    cfg["Verbosity"] = {"level": 0}
    return cfg


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
def test_run_training_trains_data_parallel(pool, tmp_path, fsdp):
    """``run_training`` under the workers' group: ``parallelism: "data"``
    (and ``HYDRAGNN_USE_FSDP``) trains the ranks' slots of each group; the
    ranks end with one state and one history."""
    from hydragnn_tpu.datasets import deterministic_graph_data

    cfg = _small_run_config()
    cfg["NeuralNetwork"]["Architecture"]["parallelism"] = "data"
    samples = tpu.port_samples(deterministic_graph_data(number_configurations=40, seed=2))
    env = {"HYDRAGNN_USE_FSDP": "1"} if fsdp else {}
    outs = pool.run("run_training", {"config": cfg, "samples": samples, "env": env,
                                     "path": str(tmp_path)})
    assert outs[0]["layout"] == ("fsdp" if fsdp else "replicated")
    for name in outs[0]["state"]:
        np.testing.assert_array_equal(outs[0]["state"][name], outs[1]["state"][name])
    assert [h["train_loss"] for h in outs[0]["history"]] == \
        [h["train_loss"] for h in outs[1]["history"]]
    assert np.isfinite(outs[0]["history"][-1]["val_loss"])


def test_run_training_validates_and_never_downgrades(monkeypatch):
    """The JAX package's refusals of impossible combinations; tensor and
    pipeline parallelism need more than one rank; supersteps under a group
    run (no refusal); a world above 1 whose group cannot be formed
    raises."""
    import torch.distributed as dist

    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.parallel import comm
    from hydragnn_tpu_torch.utils import flags

    def run(cfg):
        run_training(cfg, samples=[], device="cpu")

    cfg = _small_run_config()
    cfg["NeuralNetwork"]["Architecture"]["parallelism"] = "tensor"
    with pytest.raises(ValueError, match="'tensor' requested but no multi-rank"):
        run(cfg)
    cfg["NeuralNetwork"]["Architecture"]["parallelism"] = "sequence"
    with pytest.raises(ValueError, match="not one of"):
        run(cfg)
    cfg = _small_run_config()
    cfg["NeuralNetwork"]["Architecture"].update(halo={"enabled": True}, edge_sharding=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        run(cfg)
    cfg["NeuralNetwork"]["Architecture"].pop("edge_sharding")
    monkeypatch.setenv("HYDRAGNN_USE_FSDP", "1")
    with pytest.raises(ValueError, match="FSDP"):
        run(cfg)
    monkeypatch.setenv("HYDRAGNN_FSDP_STRATEGY", "SHARD_EVERYTHING")
    with pytest.raises(ValueError, match="HYDRAGNN_FSDP_STRATEGY"):
        flags.fsdp_mode()
    monkeypatch.setenv("HYDRAGNN_FSDP_STRATEGY", "NO_SHARD")
    assert flags.fsdp_mode() == "replicated"
    monkeypatch.delenv("HYDRAGNN_USE_FSDP")
    monkeypatch.delenv("HYDRAGNN_FSDP_STRATEGY")

    # a world of 2 whose rendezvous fails: raised, not trained alone
    monkeypatch.setenv("HYDRAGNN_AUTO_PARALLEL", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")

    def refuse(*a, **k):
        raise RuntimeError("rendezvous refused")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="rendezvous refused"):
        run(_small_run_config())
    monkeypatch.setenv("HYDRAGNN_AUTO_PARALLEL", "0")
    with pytest.raises(Exception) as alone:
        run(_small_run_config())  # alone by request: on to the (empty) data
    assert "rendezvous" not in str(alone.value)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")

    monkeypatch.setattr(comm, "live", lambda: True)
    monkeypatch.setattr(comm, "world_of", lambda group=None: 2)
    monkeypatch.setattr(comm, "rank_of", lambda group=None: 0)
    cfg = _small_run_config()
    cfg["NeuralNetwork"]["Training"]["steps_per_dispatch"] = 2
    with pytest.raises(Exception) as grouped:
        run(cfg)  # supersteps under a group: on to the (empty) data
    assert "steps_per_dispatch" not in str(grouped.value)
    assert not isinstance(grouped.value, NotImplementedError)


def test_distributed_env_cascade_and_rank_grid(monkeypatch):
    """The env cascade (schedulers, then torchrun), the job-id port, and the
    rank grid and FSDP rule of one process."""
    from hydragnn_tpu.parallel import distributed as jd
    from hydragnn_tpu_torch.parallel import distributed as d
    from hydragnn_tpu_torch.parallel.mesh import fsdp_shard_dim, make_rank_grid

    for k in ("OMPI_COMM_WORLD_SIZE", "SLURM_NPROCS", "PMI_SIZE", "JAX_NUM_PROCESSES",
              "WORLD_SIZE", "SLURM_JOB_ID", "LSB_JOBID", "PBS_JOBID", "HYDRAGNN_MASTER_PORT",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert d.init_comm_size_and_rank() == (1, 0) == jd.init_comm_size_and_rank()
    monkeypatch.setenv("SLURM_NPROCS", "8")
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_JOB_ID", "123456")
    assert d.init_comm_size_and_rank() == (8, 3) == jd.init_comm_size_and_rank()
    assert d._port_from_job_id() == jd._port_from_job_id() == 10000 + 123456 % 50000
    monkeypatch.setenv("SLURM_NODELIST", "node[07-09]")
    monkeypatch.setenv("PATH", "")  # no scontrol: the nodelist is expanded by hand
    assert d._first_host_from_nodelist() == jd._first_host_from_nodelist() == "node07"
    for k in ("SLURM_NPROCS", "SLURM_PROCID", "SLURM_JOB_ID", "SLURM_NODELIST"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert d.init_comm_size_and_rank() == (4, 2) and d.local_rank(2) == 1
    grid = make_rank_grid()
    assert (grid.world, grid.rank, grid.shape) == (1, 0, {"branch": 1, "data": 1})
    with pytest.raises(ValueError, match="rank grid"):
        make_rank_grid(n_branch=2)
    assert fsdp_shard_dim((128, 128), 2) == 0 and fsdp_shard_dim((8, 8), 2) is None
    assert fsdp_shard_dim((128, 128), 1) == 0  # one rank: one shard, as a mesh axis of 1
    assert fsdp_shard_dim((3, 2 ** 14), 4) == 1 and fsdp_shard_dim((3, 5, 2 ** 11), 3) == 0
