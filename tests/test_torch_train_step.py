"""The port's train step against the JAX package's, on the tier-1 canary
GIN (``tests/test_config.py`` ``CI_CONFIG``: hidden 8, 2 conv layers) with
one graph head and with the 4-head variant of ``tests/test_training_e2e.py``,
from the same parameters (the JAX model's, converted) on the same batch.

Tolerances, with their reasons:

* fp32 gradients and losses: XLA and PyTorch sum in other orders across a
  2-layer conv stack, batch norm and the heads, so rtol 1e-4 / atol 1e-6
  (the largest difference seen is about a tenth of that);
* parameters after an Adam/AdamW step: absolute, at ``1e-3 * lr``. An Adam
  step moves each parameter by ``lr * mu_hat / (sqrt(nu_hat) + 1e-8)``, the
  first one by about ``lr * sign(g)``; where the gradients are at the fp32
  noise of a cancelling sum (their RMS at most 1e-6 here) that step is
  decided by the noise, so those entries are held only to ``2 * lr``,
  further than one step moves a parameter;
* the bf16 step: conv layer 0 runs bf16 on both sides, where XLA and
  PyTorch may round to neighbouring bf16 values (2^-8 relative), and the
  difference is carried through the fp32 layers after it: rtol 2e-2 /
  atol 2e-3 on the gradients and the loss.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jax_loading
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.step import create_train_state as jax_create_train_state
from hydragnn_tpu.train.step import make_train_step as jax_make_train_step
from hydragnn_tpu_torch.convert import batch_from_numpy, load_optax_adam_state, port_arrays
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.step import TrainState, make_train_step
from test_config import CI_CONFIG

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# gradients at or below this are fp32 noise of a cancelling sum here (the
# gradients agree to about 1e-9 absolute)
NOISE_GRAD = 1e-6


def single_head_config():
    return copy.deepcopy(CI_CONFIG)


def four_head_config():
    """The 4-head canary of ``tests/test_training_e2e.py`` (``multihead``)."""
    cfg = copy.deepcopy(CI_CONFIG)
    arch = cfg["NeuralNetwork"]["Architecture"]
    cfg["NeuralNetwork"]["Variables_of_interest"] = {
        "input_node_features": [0],
        "output_names": ["sum", "x", "x2", "x3"],
        "output_index": [0, 1, 2, 3],
        "type": ["graph", "node", "node", "node"],
        "denormalize_output": False,
    }
    arch["task_weights"] = [20.0, 1.0, 1.0, 1.0]
    arch["output_heads"]["graph"]["dim_sharedlayers"] = 10
    arch["output_heads"]["node"] = {"num_headlayers": 2, "dim_headlayers": [10, 10],
                                    "type": "mlp"}
    cfg["NeuralNetwork"]["Training"]["batch_size"] = 16
    cfg["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"] = 0.01
    return cfg


CONFIGS = {"single_head": single_head_config, "four_heads": four_head_config}


class Setup:
    """Both packages' models from one JAX init, and the JAX train batches."""

    def __init__(self, cfg, n_samples=100):
        from hydragnn_tpu_torch.config import update_config

        samples = deterministic_graph_data(number_configurations=n_samples, seed=7)
        loaders = jax_loading(copy.deepcopy(cfg), samples=tpu.jax_samples_copy(samples))
        self.cfg = cfg
        self.jaug = jax_update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
        self.jmodel = jax_create_model_config(self.jaug)
        self.opt_cfg = self.jaug["NeuralNetwork"]["Training"]["Optimizer"]
        self.batches = list(loaders[0])
        self.jstate = jax_create_train_state(self.jmodel, jax_select_optimizer(self.opt_cfg),
                                             self.batches[0])
        self.aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
        # one jitted JAX train step per setup, shared by the tests (one compile)
        self.jstep = jax_make_train_step(self.jmodel, jax_select_optimizer(self.opt_cfg))

    def port_model(self, params=None, batch_stats=None):
        params = self.jstate.params if params is None else params
        batch_stats = self.jstate.batch_stats if batch_stats is None else batch_stats
        return tpu.port_model_from_jax(self.aug, {"params": params, "batch_stats": batch_stats})


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    return Setup(CONFIGS[request.param]())


def _jax_grads(setup, batch, dtype=jnp.float32):
    """(loss, per-task losses, gradients, updated batch stats) of the JAX
    train-mode forward, with the step's casts."""
    from hydragnn_tpu.train.step import _cast_floats

    model, state = setup.jmodel, setup.jstate
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(params):
        out, upd = model.apply(
            {"params": _cast_floats(params, dtype), "batch_stats": state.batch_stats},
            _cast_floats(jb, dtype), train=True, mutable=["batch_stats"])
        tot, tasks = model.loss(_cast_floats(out, jnp.float32), jb)
        return tot, (tasks, upd["batch_stats"])

    (tot, (tasks, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    return float(tot), np.asarray(jnp.stack(tasks)), port_arrays(tpu.numpy_tree(grads)), \
        port_arrays(tpu.numpy_tree(stats))


def _port_grads(model, batch, dtype=torch.float32):
    from hydragnn_tpu_torch.train.step import cast_forward

    pb = batch_from_numpy(batch)
    pred = cast_forward(model, pb, dtype, train=True)
    tot, tasks = model.loss(pred, pb)
    tot.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return float(tot.detach()), torch.stack(tasks).detach().numpy(), grads


def test_parameter_gradients_match_jax(setup):
    """Loss, per-task losses, every parameter's gradient and the updated
    running statistics of one train-mode forward and backward."""
    batch = setup.batches[0]
    j_loss, j_tasks, j_grads, j_stats = _jax_grads(setup, batch)
    port = setup.port_model()
    p_loss, p_tasks, p_grads = _port_grads(port, batch)
    np.testing.assert_allclose(p_loss, j_loss, **GRAD_TOL)
    np.testing.assert_allclose(p_tasks, j_tasks, **GRAD_TOL)
    assert set(p_grads) == set(j_grads)
    for name, g in p_grads.items():
        np.testing.assert_allclose(g, j_grads[name], **GRAD_TOL, err_msg=name)
    for name, v in port.state_dict().items():
        if name in j_stats:
            np.testing.assert_allclose(v.numpy(), j_stats[name], **GRAD_TOL, err_msg=name)
    assert any(abs(float(p.grad)) > 0 for n, p in port.named_parameters() if n.endswith("eps")), \
        "GIN's eps is trainable"


def test_bf16_step_gradients_match_jax(setup):
    """The bf16 step: parameters and batch cast inside the differentiated
    function, fp32 gradients for the fp32 masters, running statistics
    fp32."""
    batch = setup.batches[0]
    j_loss, _, j_grads, j_stats = _jax_grads(setup, batch, jnp.bfloat16)
    port = setup.port_model()
    p_loss, _, p_grads = _port_grads(port, batch, torch.bfloat16)
    assert all(p.grad.dtype == torch.float32 for p in port.parameters())
    assert all(b.dtype == torch.float32 for b in port.buffers())
    np.testing.assert_allclose(p_loss, j_loss, rtol=2e-2, atol=2e-3)
    for name, g in p_grads.items():
        np.testing.assert_allclose(g, j_grads[name], rtol=2e-2, atol=2e-3, err_msg=name)
    for name, v in port.state_dict().items():
        if name in j_stats:
            np.testing.assert_allclose(v.numpy(), j_stats[name], rtol=2e-2, atol=2e-3)


def _adam_state(opt_state):
    """The optax Adam moments inside an injected AdamW state."""
    def is_adam(x):
        return hasattr(x, "mu") and hasattr(x, "nu")

    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam):
        if is_adam(leaf):
            return leaf
    raise AssertionError("no Adam state in the optax state")


def _assert_params_close(port, jstate, err=""):
    """Parameters after an Adam step of ``jstate`` within ``1e-3 * lr``,
    except where the gradients' running RMS ``sqrt(nu_hat)`` is at most
    ``NOISE_GRAD``: there the step ``lr * mu_hat / (sqrt(nu_hat) + 1e-8)``
    is decided by fp32 noise in the gradients, and those entries are held to
    ``2 * lr``, further than any step moves a parameter."""
    lr = float(jstate.opt_state.hyperparams["learning_rate"])
    adam = _adam_state(jstate.opt_state)
    rms = port_arrays(tpu.numpy_tree(jax.tree.map(
        lambda v: jnp.sqrt(v / (1.0 - 0.999 ** int(adam.count))), adam.nu)))
    want = port_arrays(tpu.numpy_tree(jstate.params))
    for name, p in port.named_parameters():
        atol = np.where(rms[name] <= NOISE_GRAD, 2 * lr, 1e-3 * lr)
        diff = np.abs(p.detach().numpy() - want[name])
        assert (diff <= atol).all(), f"{err} {name}: max |diff| {diff.max():.3e}"


def test_one_adamw_step_matches_optax(setup):
    """One AdamW step (optax's weight decay 1e-4, passed explicitly to
    torch) from the same state on the same batch."""
    batch = setup.batches[0]
    jnew, jmetrics = setup.jstep(setup.jstate, jax.tree.map(jnp.asarray, batch))
    port = setup.port_model()
    state = TrainState(port, select_optimizer(setup.opt_cfg, port.parameters()))
    metrics = make_train_step()(state, batch_from_numpy(batch))
    assert state.step == 1 and int(jnew.step) == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), **GRAD_TOL)
    np.testing.assert_allclose(metrics["tasks_loss"].numpy(), np.asarray(jmetrics["tasks_loss"]),
                               **GRAD_TOL)
    assert float(metrics["num_graphs"]) == float(jmetrics["num_graphs"])
    _assert_params_close(port, jnew, "after one step:")


def test_converted_mid_training_state_steps_like_jax(setup):
    """Three JAX steps, then the whole train state carried across by
    ``convert`` (parameters, running statistics, AdamW moments, step count,
    injected learning rate); one more step on each side gives the same
    parameters, which holds Adam's bias correction beyond step 1."""
    from hydragnn_tpu_torch.convert import load_jax_variables

    batches = [jax.tree.map(jnp.asarray, b) for b in setup.batches[:4]]
    assert len(batches) == 4
    jstep = setup.jstep
    jstate = setup.jstate
    for b in batches[:3]:
        jstate, _ = jstep(jstate, b)
    adam = _adam_state(jstate.opt_state)
    lr = float(jstate.opt_state.hyperparams["learning_rate"])

    port = setup.port_model()
    state = TrainState(port, select_optimizer(setup.opt_cfg, port.parameters()))
    load_jax_variables(port, tpu.numpy_tree(jstate.params), tpu.numpy_tree(jstate.batch_stats))
    load_optax_adam_state(state.optimizer, port, tpu.numpy_tree(adam.mu),
                          tpu.numpy_tree(adam.nu), int(adam.count), lr)
    state.step = int(jstate.step)
    assert int(adam.count) == 3

    jstate, _ = jstep(jstate, batches[3])
    make_train_step()(state, batch_from_numpy(setup.batches[3]))
    _assert_params_close(port, jstate, "after the fourth step:")
    stats = port_arrays(tpu.numpy_tree(jstate.batch_stats))
    for name, v in port.state_dict().items():
        if name in stats:
            np.testing.assert_allclose(v.numpy(), stats[name], **GRAD_TOL, err_msg=name)


# -- optimizers ----------------------------------------------------------------


@pytest.mark.parametrize("opt", [
    {"type": "AdamW", "learning_rate": 0.01},
    {"type": "AdamW", "learning_rate": 0.01, "weight_decay": 0.05},
    {"type": "Adam", "learning_rate": 0.01},
    {"type": "SGD", "learning_rate": 0.1},
])
def test_optimizers_match_optax(opt):
    """Three steps of each ported optimizer on the same parameters and
    gradients as the JAX package's optax chain."""
    import optax

    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    jopt = jax_select_optimizer(opt)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = select_optimizer(opt, list(tp.values()))
    for g in grads:
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)


def test_unported_optimizers_raise_and_plateau_schedule_matches_jax():
    from hydragnn_tpu.train.optimizer import ReduceLROnPlateau as JaxPlateau
    from hydragnn_tpu_torch.train.optimizer import (
        ReduceLROnPlateau,
        get_learning_rate,
        set_learning_rate,
    )

    from hydragnn_tpu_torch.train import optimizer as opt_mod

    # the five other optax types are ported (tests/test_torch_optimizers.py
    # holds them against optax); an unknown type still raises
    p = [torch.nn.Parameter(torch.zeros(2))]
    for t, cls in (("RMSprop", opt_mod.OptaxRMSProp), ("Adagrad", opt_mod.OptaxAdagrad),
                   ("Adadelta", opt_mod.OptaxAdadelta), ("Adamax", opt_mod.OptaxAdamax),
                   ("FusedLAMB", opt_mod.OptaxLAMB)):
        assert isinstance(select_optimizer({"type": t, "learning_rate": 0.1}, p), cls)
    with pytest.raises(NameError):
        select_optimizer({"type": "Nope", "learning_rate": 0.1}, p)
    opt = select_optimizer({"type": "AdamW", "learning_rate": 0.1}, p)
    assert opt.param_groups[0]["weight_decay"] == 1e-4
    set_learning_rate(opt, 0.05)
    assert get_learning_rate(opt) == 0.05
    metrics = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.8, 0.9, 0.9] + [0.9] * 14
    ours, theirs = ReduceLROnPlateau(0.1), JaxPlateau(0.1)
    assert [ours.step(m) for m in metrics] == [theirs.step(m) for m in metrics]
    assert ours.state_dict() == theirs.state_dict() and ours.lr < 0.1


def test_initial_bias_and_frozen_conv_layers_match_jax(setup):
    """``initial_bias`` fills the last bias of every graph head; with
    ``freeze_conv_layers`` the conv stack and the norms get zero gradients
    and the heads keep theirs."""
    from hydragnn_tpu.train.step import apply_initial_bias as jax_initial_bias
    from hydragnn_tpu.train.step import freeze_conv_grads as jax_freeze
    from hydragnn_tpu_torch.config import ModelSpec
    from hydragnn_tpu_torch.train.step import apply_initial_bias, freeze_conv_grads

    aug = copy.deepcopy(setup.aug)
    aug["NeuralNetwork"]["Architecture"].update(initial_bias=0.25, freeze_conv_layers=True)
    port = setup.port_model()
    port.spec = ModelSpec.from_config(aug)
    apply_initial_bias(port)
    jspec = setup.jmodel.spec.__class__(**{**setup.jmodel.spec.__dict__, "initial_bias": 0.25,
                                           "freeze_conv_layers": True})
    want = port_arrays(tpu.numpy_tree(jax_initial_bias(
        jax.tree.map(lambda x: x, setup.jstate.params), jspec)))
    for name, p in port.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name], err_msg=name)
    _port_grads(port, setup.batches[0])
    freeze_conv_grads(port)
    jfrozen = port_arrays(tpu.numpy_tree(jax_freeze(
        jax.tree.map(jnp.ones_like, setup.jstate.params), jspec)))
    for name, p in port.named_parameters():
        assert bool((p.grad == 0).all()) == (not jfrozen[name].any()), name
