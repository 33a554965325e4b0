"""The port's tensor parallelism (``hydragnn_tpu_torch/parallel/tensor.py``,
``mesh.py::TPGrid``) on 2 and 4 ``gloo`` worker processes
(``torch_parallel_pool.py``), against the JAX package's ``param_mode="tp"``
step on a ``(data x model)`` mesh of the conftest's CPU devices and against
the port's own one-device step, on the tier-1 canary GIN
(``tests/test_config.py``) at hidden 32: its 32 x 32 dense weights have
2**10 entries, the least the column rule shards, so every conv layer's
second dense layer and the 32-wide shared head layers shard, and the
gather-scatter kernel runs on a 16- or 8-wide feature shard.

Tolerances, with their reasons:

* losses: rtol 1e-5 (the sums associate otherwise);
* parameters after one SGD step (lr 0.1) against the JAX package's TP mesh
  step: rtol 1e-5, atol 1e-6 (SGD keeps the deltas proportional to the
  gradients);
* parameters after one AdamW step against the port's one-device step:
  rtol 1e-5, atol 1e-5. Adam's first step moves every parameter by about
  ``lr`` whatever its gradient's size, so a gradient that is zero in exact
  arithmetic (a dense bias feeding a batch norm, whose mean cancels it, and
  the weights from a constant input column into one) comes out as rounding
  noise of either sign in both runs and its step as +-lr: the entries
  whose one-device gradient is below ``NOISE_GRAD`` are held to the step's
  size instead;
* running statistics: rtol 1e-5, atol 1e-6;
* every rank holds the same state after the step, bit for bit.
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
ADAM_TOL = dict(rtol=1e-5, atol=1e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
NOISE_GRAD = 1e-6
SGD = {"type": "SGD", "learning_rate": 0.1}
HIDDEN = 32


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(world):
        if world not in made:
            made[world] = WorkerPool(tmp_path_factory.mktemp(f"tp{world}"), world=world)
        return made[world]

    yield get
    for p in made.values():
        p.close()


_SETUP: dict = {}


def _setup() -> Setup:
    if "s" not in _SETUP:
        cfg = copy.deepcopy(CI_CONFIG)
        arch = cfg["NeuralNetwork"]["Architecture"]
        arch["hidden_dim"] = HIDDEN
        arch["output_heads"]["graph"]["dim_sharedlayers"] = HIDDEN
        _SETUP["s"] = Setup(cfg, n_samples=60)
    return _SETUP["s"]


def _arrays(batch) -> dict:
    return {f: np.asarray(getattr(batch, f)) for f in FIELDS}


def _inputs(s: Setup, n_model: int, opt=SGD) -> dict:
    model = s.port_model()
    return {"aug": s.aug, "opt": opt, "n_model": n_model,
            "batches": [_arrays(b) for b in s.batches[:2]],
            "state": {k: v.numpy() for k, v in model.state_dict().items()}}


def _jax_tp_step(s: Setup, n_data: int, n_model: int):
    """The JAX package's TP step over a ``(n_data x n_model)`` mesh on the
    first ``n_data`` batches, stacked."""
    from hydragnn_tpu.parallel import (make_mesh, make_parallel_train_step, put_batch,
                                       shard_state, stack_device_batches)

    mesh = make_mesh(n_data=n_data, n_model=n_model,
                     devices=jax.devices()[:n_data * n_model])
    opt = jax_select_optimizer(SGD)
    params = jax.tree.map(jnp.array, s.jstate.params)
    state = JaxTrainState(params=params,
                          batch_stats=jax.tree.map(jnp.array, s.jstate.batch_stats),
                          opt_state=opt.init(params), step=jnp.asarray(0))
    state = shard_state(state, mesh, param_mode="tp")
    sb = put_batch(stack_device_batches(list(s.batches[:n_data])), mesh)
    new, metrics = make_parallel_train_step(s.jmodel, opt, mesh)(state, sb)
    return ({k: np.asarray(v) for k, v in metrics.items()},
            port_arrays(tpu.numpy_tree(new.params)),
            port_arrays(tpu.numpy_tree(new.batch_stats)))


def _assert_ranks_equal(outs):
    for name in outs[0]["state"]:
        for out in outs[1:]:
            np.testing.assert_array_equal(out["state"][name], outs[0]["state"][name],
                                          err_msg=name)


@pytest.mark.parametrize("world,n_model", [(2, 2), (4, 4), (4, 2)],
                         ids=["1x2", "1x4", "2x2"])
def test_tensor_parallel_step_matches_the_jax_tp_mesh(pools, world, n_model):
    s = _setup()
    n_data = world // n_model
    outs = pools(world).run("tp_step", _inputs(s, n_model))
    metrics, params, stats = _jax_tp_step(s, n_data, n_model)
    width = HIDDEN // n_model
    for r, out in enumerate(outs):
        assert out["grid"] == (n_data, n_model, r // n_model, r % n_model)
        # the conv layers' second dense weights and the shared head layer
        assert len(out["shards"]) >= 3 and all(
            shard[0] == HIDDEN // n_model for _, _, shard in out["shards"])
        # B1 on the feature shard after conv layer 0's raw input
        assert width in out["widths"] and out["widths"][0] == 1, out["widths"]
        np.testing.assert_allclose(out["step"]["loss"], metrics["loss"], **LOSS_TOL)
        assert float(out["step"]["num_graphs"]) == float(metrics["num_graphs"])
        for name, w in params.items():
            np.testing.assert_allclose(out["state"][name], w, **PARAM_TOL,
                                       err_msg=f"rank {r} {name}")
        for name, w in stats.items():
            np.testing.assert_allclose(out["state"][name], w, **STAT_TOL,
                                       err_msg=f"rank {r} {name}")
    _assert_ranks_equal(outs)


@pytest.mark.parametrize("world", [2, 4])
def test_model_group_matches_the_one_device_adamw_step(pools, world):
    """A model group of 2 and of 4 ranks (one data group) against the
    port's one-device step on the same batch, one AdamW step each."""
    from hydragnn_tpu_torch.train.step import create_train_state, make_eval_step, \
        make_train_step

    s = _setup()
    adam = s.opt_cfg
    outs = pools(world).run("tp_step", _inputs(s, world, opt=adam))
    model = s.port_model()
    state = create_train_state(model, adam, seed=0)
    batch = batch_from_numpy(s.batches[0])
    ev = make_eval_step()(state, batch)
    step = make_train_step()(state, batch)
    noise = {n: (p.grad.abs() <= NOISE_GRAD).numpy() for n, p in model.named_parameters()}
    lr = float(adam["learning_rate"])
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["eval"]["loss"], ev["loss"].numpy(), **LOSS_TOL)
        np.testing.assert_allclose(out["step"]["loss"], step["loss"].numpy(), **LOSS_TOL)
        for name, w in model.state_dict().items():
            got, want = out["state"][name], w.numpy()
            quiet = noise.get(name, np.zeros(want.shape, bool))
            assert np.abs(got - want)[quiet].max(initial=0.0) <= 2.1 * lr, name
            np.testing.assert_allclose(got[~quiet], want[~quiet], **ADAM_TOL,
                                       err_msg=f"rank {r} {name}")
    _assert_ranks_equal(outs)


def test_column_rule_and_the_grid_match_the_jax_package():
    """``tp_shard_dim`` shards what ``tp_param_specs`` shards (the port's
    dense weights transposed), the default model width is the JAX
    package's, and the support check refuses what the route does not run."""
    from hydragnn_tpu.parallel.mesh import make_mesh, tp_param_specs
    from hydragnn_tpu_torch.convert import port_arrays as to_port
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.parallel.mesh import tp_shard_dim
    from hydragnn_tpu_torch.parallel.tensor import (default_tensor_parallel_size,
                                                    validate_tensor_parallel_support)

    s = _setup()
    for n in (2, 4):
        specs = tp_param_specs(s.jstate.params, make_mesh(n_data=1, n_model=n,
                                                          devices=jax.devices()[:n]))
        flat = to_port(jax.tree.map(lambda p: np.asarray(p != jax.sharding.PartitionSpec()),
                                    specs, is_leaf=lambda x: isinstance(
                                        x, jax.sharding.PartitionSpec)))
        model = s.port_model()
        for name, p in model.named_parameters():
            assert (tp_shard_dim(p.shape, n) is not None) == bool(flat[name]), name
    assert [default_tensor_parallel_size(w) for w in (2, 4, 6, 8)] == [2, 4, 2, 4]
    assert default_tensor_parallel_size(8, {"tensor_parallel_size": 2}) == 2
    gat = copy.deepcopy(s.aug)
    gat["NeuralNetwork"]["Architecture"]["mpnn_type"] = "GAT"
    with pytest.raises(NotImplementedError, match="GAT"):
        validate_tensor_parallel_support(create_model_config(gat, device="cpu"), 2)
    with pytest.raises(ValueError, match="hidden_dim"):
        validate_tensor_parallel_support(s.port_model(), 3)


def test_run_training_trains_tensor_parallel(pools, tmp_path):
    """``parallelism: "tensor"`` through ``run_training`` on 4 ranks (the
    default model width 4): the ranks end with one state and the loss
    falls."""
    from hydragnn_tpu.datasets import deterministic_graph_data

    cfg = copy.deepcopy(_setup().cfg)
    cfg["NeuralNetwork"]["Architecture"]["parallelism"] = "tensor"
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 3
    samples = tpu.port_samples(deterministic_graph_data(number_configurations=64, seed=5))
    outs = pools(4).run("run_training", {"config": cfg, "samples": samples,
                                         "path": str(tmp_path)})
    _assert_ranks_equal(outs)
    assert outs[0]["layout"] == "tp"
    losses = [h["train_loss"] for h in outs[0]["history"]]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    assert all(np.isfinite(torch.as_tensor(v).numpy()).all() for v in outs[0]["state"].values())
