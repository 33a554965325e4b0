"""The port's GPipe pipeline (``hydragnn_tpu_torch/parallel/pipeline.py``)
on 2 and 4 ``gloo`` stage processes (``torch_parallel_pool.py``), against
the JAX package's sequential forward and its ``make_pipelined_train_step``
over a 2- and 4-device stage mesh of the conftest's 8 CPU devices, on the
tier-1 canary GIN (``tests/test_config.py``, hidden 8) at 5 conv layers
(block 0 and 4 pipelined blocks: 2 per stage at 2 stages, 1 at 4), 4
microbatches of 4 graphs. The JAX parameters are carried across by
``convert.py``.

Tolerances, with their reasons:

* the pipelined eval forward (``norm="running"``) against the JAX
  sequential forward: rtol 1e-5, atol 1e-6 (fp32; XLA and PyTorch sum in
  other orders); against the port's own one-device forward: equal bit for
  bit (the same operations per microbatch, moved between processes whole);
* parameters after one pipelined SGD step (lr 0.1, ``norm="batch"``):
  rtol 1e-5, atol 1e-6, and the running statistics rtol 1e-5, atol 1e-6
  (SGD keeps the parameter deltas proportional to the gradients);
* every stage holds the same state, bit for bit;
* a stage's optimizer steps the prologue, its own blocks and the
  epilogue only; two stages' AdamW steps, gathered, and a checkpoint's
  optimizer state equal the one-stage pipeline's bit for bit (the same
  operations per microbatch, the prologue's gradient summed with zeros),
  and so does a run resumed from that checkpoint.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_util as tpu
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.step import TrainState as JaxTrainState
from hydragnn_tpu_torch.convert import port_arrays
from hydragnn_tpu_torch.graphs.graph import FIELDS
from test_config import CI_CONFIG
from test_torch_train_step import Setup
from torch_parallel_pool import WorkerPool

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
SGD = {"type": "SGD", "learning_rate": 0.1}
N_MICRO = 4


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(world):
        if world not in made:
            made[world] = WorkerPool(tmp_path_factory.mktemp(f"pipe{world}"), world=world)
        return made[world]

    yield get
    for p in made.values():
        p.close()


def _config(layers: int = 5, mpnn: str = "GIN") -> dict:
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Architecture"]["num_conv_layers"] = layers
    cfg["NeuralNetwork"]["Architecture"]["mpnn_type"] = mpnn
    cfg["NeuralNetwork"]["Training"]["batch_size"] = 4
    return cfg


_SETUP: dict = {}


def _setup() -> Setup:
    if "s" not in _SETUP:
        _SETUP["s"] = Setup(_config(), n_samples=24)
    return _SETUP["s"]


def _arrays(batch) -> dict:
    return {f: np.asarray(getattr(batch, f)) for f in FIELDS}


def _inputs(s: Setup, **kw) -> dict:
    model = s.port_model()
    return {"aug": s.aug, "opt": SGD, "batches": [_arrays(b) for b in s.batches[:N_MICRO]],
            "state": {k: v.numpy() for k, v in model.state_dict().items()}, **kw}


def _jax_sequential(s: Setup) -> list:
    variables = {"params": s.jstate.params, "batch_stats": s.jstate.batch_stats}
    return [[np.asarray(o) for o in s.jmodel.apply(variables, jax.tree.map(jnp.asarray, b),
                                                   False)]
            for b in s.batches[:N_MICRO]]


def _jax_pipelined_step(s: Setup, n_stage: int):
    from hydragnn_tpu.parallel import stack_device_batches
    from hydragnn_tpu.parallel.pipeline import (make_pipeline_mesh, make_pipelined_train_step,
                                                put_microbatches)

    mesh = make_pipeline_mesh(n_stage, jax.devices()[:n_stage])
    opt = jax_select_optimizer(SGD)
    params = jax.tree.map(jnp.array, s.jstate.params)
    state = JaxTrainState(params=params,
                          batch_stats=jax.tree.map(jnp.array, s.jstate.batch_stats),
                          opt_state=opt.init(params), step=jnp.asarray(0))
    mb = put_microbatches(stack_device_batches(list(s.batches[:N_MICRO])), mesh)
    new, metrics = make_pipelined_train_step(s.jmodel, opt, mesh, n_micro=N_MICRO)(state, mb)
    return ({k: np.asarray(v) for k, v in metrics.items()},
            port_arrays(tpu.numpy_tree(new.params)),
            port_arrays(tpu.numpy_tree(new.batch_stats)))


@pytest.mark.parametrize("n_stage", [2, 4])
def test_pipelined_step_matches_jax(pools, n_stage):
    """One pool run per stage count: the pipelined eval forward against the
    JAX sequential forward and the port's own, then one pipelined train step
    against JAX's ``make_pipelined_train_step``."""
    s = _setup()
    outs = pools(n_stage).run("pipeline", _inputs(s))
    want = _jax_sequential(s)
    metrics, params, stats = _jax_pipelined_step(s, n_stage)
    k = (s.aug["NeuralNetwork"]["Architecture"]["num_conv_layers"] - 1) // n_stage
    for r, out in enumerate(outs):
        assert out["blocks"] == list(range(1 + r * k, 1 + (r + 1) * k))
        for m in range(N_MICRO):
            for got, seq, ref in zip(out["pipelined"][m], out["sequential"][m], want[m]):
                np.testing.assert_array_equal(got, seq, err_msg=f"rank {r} microbatch {m}")
                np.testing.assert_allclose(got, ref, **FWD_TOL,
                                           err_msg=f"rank {r} microbatch {m} vs JAX")
        step = out["steps"][0]
        np.testing.assert_allclose(step["loss"], metrics["loss"], **FWD_TOL)
        np.testing.assert_allclose(step["tasks_loss"], metrics["tasks_loss"], **FWD_TOL)
        assert float(step["num_graphs"]) == float(metrics["num_graphs"])
        for name, w in params.items():
            np.testing.assert_allclose(out["state"][name], w, **PARAM_TOL,
                                       err_msg=f"rank {r} {name}")
        for name, w in stats.items():
            np.testing.assert_allclose(out["state"][name], w, **STAT_TOL,
                                       err_msg=f"rank {r} {name}")
    for name in outs[0]["state"]:
        for out in outs[1:]:
            np.testing.assert_array_equal(out["state"][name], outs[0]["state"][name])


def test_each_stage_holds_its_blocks_and_checkpoints_hold_them_all(pools, tmp_path):
    """2 stages, AdamW, 3 steps with a checkpoint after the first: each
    stage's optimizer holds its own blocks (with the prologue and the
    epilogue) and no other; the gathered state and the checkpoint layout's
    optimizer state equal the one-stage pipeline's, and the run resumed from
    the checkpoint ends where the uninterrupted one does."""
    import torch

    from hydragnn_tpu_torch.convert import batch_from_numpy
    from hydragnn_tpu_torch.parallel.pipeline import make_pipelined_train_step, place_pipeline
    from hydragnn_tpu_torch.train.step import create_train_state

    s = _setup()
    adam = s.opt_cfg
    outs = pools(2).run("pipeline_layout", _inputs(s, opt=adam, steps=3, save_after=1,
                                                   path=str(tmp_path)))
    model = s.port_model()
    state = place_pipeline(create_train_state(model, adam, seed=0), adam)
    step = make_pipelined_train_step(model, n_micro=N_MICRO)
    batches = tuple(batch_from_numpy(b) for b in s.batches[:N_MICRO])
    for _ in range(3):
        step(state, batches)
    names = [n for n, _ in model.named_parameters()]
    ring = {r: [n for i in (1 + 2 * r, 2 + 2 * r) for n in names
                if n.startswith((f"graph_convs.{i}.", f"feature_layers.{i}."))] for r in range(2)}
    for r, out in enumerate(outs):
        others = set(ring[1 - r])
        assert out["held"] == [n for n in names if n not in others], r
        for name, want in model.state_dict().items():
            np.testing.assert_array_equal(out["state"][name], want.numpy(), err_msg=name)
            np.testing.assert_array_equal(out["resumed_state"][name], want.numpy(),
                                          err_msg=f"resumed {name}")
        want = state.optimizer.state_dict()["state"]
        for got in (out["optimizer"], out["resumed_optimizer"]):
            assert sorted(got) == sorted(want)
            for i, per in want.items():
                for k, v in per.items():
                    if torch.is_tensor(v):
                        np.testing.assert_array_equal(got[i][k], v.numpy(),
                                                      err_msg=f"{names[i]} {k}")


def test_pipeline_refusals_match_jax():
    """The JAX package's refusals (``tests/test_pipeline.py:46-76``): stage
    counts that do not divide the pipelined blocks, too few blocks, GAT with
    dropout, and a step given another number of microbatches than M."""
    from hydragnn_tpu.parallel.pipeline import (
        validate_pipeline_support as jax_validate)
    from hydragnn_tpu_torch.parallel.pipeline import Pipeline, pipelined_forward, \
        validate_pipeline_support

    s = _setup()
    port = s.port_model()
    for n_stage, want in ((4, 1), (2, 2)):
        assert validate_pipeline_support(port, n_stage) == jax_validate(s.jmodel, n_stage) \
            == want
    for n_stage, match in ((3, "divisible"), (5, "stages")):
        with pytest.raises(ValueError, match=match):
            jax_validate(s.jmodel, n_stage)
        with pytest.raises(ValueError, match=match):
            validate_pipeline_support(port, n_stage)
    from hydragnn_tpu_torch.models import create_model_config

    gat_cfg = copy.deepcopy(s.aug)
    gat_cfg["NeuralNetwork"]["Architecture"].update(mpnn_type="GAT", dropout=0.2)
    gat = create_model_config(gat_cfg, device="cpu")
    with pytest.raises(ValueError, match="dropout"):
        validate_pipeline_support(gat, 2)
    # without dropout GAT still does not pipeline: its last layer averages
    # its heads, so blocks 1..L-1 differ in shape (the JAX package's
    # _stack_layer_params refuses it when it stacks them)
    gat_cfg["NeuralNetwork"]["Architecture"]["dropout"] = 0.0
    with pytest.raises(ValueError, match="homogeneous"):
        validate_pipeline_support(create_model_config(gat_cfg, device="cpu"), 2)
    from hydragnn_tpu_torch.convert import batch_from_numpy

    batches = [batch_from_numpy(b) for b in s.batches[:3]]
    with pytest.raises(ValueError, match="leading dim"):
        pipelined_forward(Pipeline(port, N_MICRO, "running"), batches, train=False)
    with pytest.raises(ValueError, match="norm"):
        Pipeline(port, N_MICRO, "frozen")


def test_run_training_trains_pipelined_and_predicts_on_one_device(pools, tmp_path):
    """``parallelism: "pipeline"`` through ``run_training`` on 2 ranks
    (``pipeline_microbatches`` 2): the ranks end with one state, the loss
    falls, and ``run_prediction`` evaluates the run's final checkpoint on
    the one-device path."""
    from hydragnn_tpu.datasets import deterministic_graph_data
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.config import get_log_name_config, update_config
    from hydragnn_tpu_torch.train.checkpoint import load_model_checkpoint
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = _config(layers=3)
    arch, training = cfg["NeuralNetwork"]["Architecture"], cfg["NeuralNetwork"]["Training"]
    arch.update(parallelism="pipeline", pipeline_microbatches=2)
    training.update(num_epoch=3, batch_size=8)
    samples = tpu.port_samples(deterministic_graph_data(number_configurations=64, seed=5))
    outs = pools(2).run("run_training", {"config": cfg, "samples": samples,
                                         "path": str(tmp_path)})
    for name in outs[0]["state"]:
        np.testing.assert_array_equal(outs[1]["state"][name], outs[0]["state"][name])
    losses = [h["train_loss"] for h in outs[0]["history"]]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    fresh = tpu.port_samples(deterministic_graph_data(number_configurations=64, seed=5))
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=fresh)
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
    model = create_model_config(aug, device="cpu")
    load_model_checkpoint(model, get_log_name_config(aug), path=str(tmp_path / "0"))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), outs[0]["state"][k])
    error, tasks, _, _ = run_prediction(
        cfg, model, samples=tpu.port_samples(deterministic_graph_data(
            number_configurations=64, seed=5)), device="cpu")
    assert np.isfinite(error) and np.isfinite(tasks).all()
