"""Training the geometric conv stacks PAINN, PNAEq, DimeNet and MACE in the
port against the JAX package: per stack, the train-mode loss and parameter
gradients (fp32 and the bf16 step) and one AdamW step from the same
parameters on the same batch, on the 4-head BCC canary configuration of
``tests/test_training_e2e.py`` (hidden 8, 2 conv layers, batch 16, lr 0.01,
the stack's ``ARCH_OVERRIDES``; DimeNet's samples get their triplets in
preprocessing, as ``run_training`` attaches them); and, slow-marked, each
stack's canary itself through the port's ``run_training`` on the CPU, at
the reference's ``THRESHOLDS``.

Tolerances, with their reasons:

* fp32 loss: rtol 1e-4 / atol 1e-6, the GIN's. Gradients per tensor: max
  |port - JAX| within 1e-5 of the tensor's largest gradient (1e-3 of the
  model's largest where the tensor's own is smaller: its gradients are
  then sums that cancel to fp32 noise), or within twice the JAX package's
  own fp32 error on that tensor against the port's fp64 gradient, where
  that is larger. Measured, the second applies to PNAEq's conv layer 0
  only: its std aggregator of messages that are often equal on the BCC
  lattice amplifies rounding (as PNA's, ``tests/test_torch_invariant_
  train.py``), and the port misses JAX there by 2e-8 on gradients of 2e-4
  (``scalar_mlp_1.bias``), 3.9e-5 of the tensor's largest entry.
* MACE's last layer has parameters no output reads (its ``l = 1`` blocks,
  which the sizing to scalars drops): JAX gives them a zero gradient and
  the port's step does too (``optimizer_step``), so the test compares
  zeros there.
* The bf16 step (the JAX package's fused kernels on): per entry, the GIN's
  rtol 2e-2 / atol 2e-3 plus the JAX package's own distance from its fp32
  gradient (``tests/test_torch_invariant_train.py``'s bound; never the
  port's own distance). It runs with ``activation_function: silu``: under
  the canary's relu, a pre-activation within bf16 noise of 0 takes the
  other branch in one package and not the other, and zeroes a gradient
  there (PAINN's shared graph layer: a pre-activation just above 0 in
  fp32 fell below it in the port's bf16 only). Under relu the
  largest share of the bound reads 10.2 (PAINN), 1.56 (PNAEq), 2.20
  (DimeNet) and 0.11 (MACE); under silu 0.05, 0.16, 0.81 and 0.16
  (``tests/bf16_readings.py``).
* Parameters after one AdamW step: ``_assert_params_close`` of
  ``tests/test_torch_train_step.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu_torch.convert import batch_from_numpy
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.step import TrainState, make_train_step
from test_torch_train_step import GRAD_TOL, Setup, _assert_params_close, _jax_grads, \
    four_head_config
from test_training_e2e import ARCH_OVERRIDES, THRESHOLDS

STACKS = ("PAINN", "PNAEq", "DimeNet", "MACE")
REL = 1e-5  # of the tensor's largest gradient (floor: 1e-3 of the model's)


def stack_config(stack):
    cfg = four_head_config()
    cfg["NeuralNetwork"]["Architecture"].update(mpnn_type=stack, **ARCH_OVERRIDES[stack])
    return cfg


@pytest.fixture(scope="module", params=STACKS)
def setup(request):
    return Setup(stack_config(request.param))


def _port_grads(model, batch, dtype=torch.float32):
    """Loss, per-task losses and every parameter's gradient (0 where no
    output reads the parameter, as the train step fills it)."""
    from hydragnn_tpu_torch.train.step import cast_forward

    pb = batch_from_numpy(batch)
    pred = cast_forward(model, pb, dtype, train=True)
    tot, tasks = model.loss(pred, pb)
    tot.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for n, p in model.named_parameters()}
    return float(tot.detach()), torch.stack(tasks).detach().numpy(), grads


def test_parameter_gradients_match_jax(setup):
    batch = setup.batches[0]
    j_loss, j_tasks, j_grads, _ = _jax_grads(setup, batch)
    p_loss, p_tasks, p_grads = _port_grads(setup.port_model(), batch)
    np.testing.assert_allclose(p_loss, j_loss, **GRAD_TOL)
    np.testing.assert_allclose(p_tasks, j_tasks, **GRAD_TOL)
    assert set(p_grads) == set(j_grads)
    ref = setup.port_model()
    ref.double()
    _, _, fp64 = _port_grads(ref, batch, torch.float64)
    model_max = max(float(np.abs(g).max()) for g in j_grads.values())
    for name, g in p_grads.items():
        want = j_grads[name]
        scale = max(float(np.abs(want).max()), 1e-3 * model_max)
        jax_err = float(np.abs(want - fp64[name]).max())
        err = float(np.abs(g - want).max())
        assert err <= max(REL * scale, 2 * jax_err), \
            f"{name}: max|diff| {err:.3e} > {REL} x {scale:.3e} and 2 x {jax_err:.3e}"
    live = [n for n in p_grads if n.startswith("graph_convs.0")]
    assert all(np.abs(p_grads[n]).max() > 0 for n in live), \
        "every parameter of conv layer 0 gets a gradient"


@pytest.mark.parametrize("stack", STACKS)
def test_bf16_step_gradients_match_jax(stack, monkeypatch):
    """The bf16 step's loss and gradients (fp32 for the fp32 masters), on
    the canary configuration with silu for relu (module docstring)."""
    monkeypatch.setenv("HYDRAGNN_FUSED_SCATTER", "1")
    cfg = stack_config(stack)
    cfg["NeuralNetwork"]["Architecture"]["activation_function"] = "silu"
    setup = Setup(cfg)
    batch = setup.batches[0]
    j_loss, _, j_grads, _ = _jax_grads(setup, batch, jnp.bfloat16)
    _, _, j_fp32, _ = _jax_grads(setup, batch)
    port = setup.port_model()
    p_loss, _, p_grads = _port_grads(port, batch, torch.bfloat16)
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in port.parameters())
    np.testing.assert_allclose(p_loss, j_loss, rtol=2e-2, atol=2e-3)
    for name, g in p_grads.items():
        tpu.assert_within_jax_bf16_gap(g, j_grads[name], j_fp32[name], rtol=2e-2, atol=2e-3,
                                       what=name)


def test_one_adamw_step_matches_optax(setup):
    batch = setup.batches[0]
    jnew, jmetrics = setup.jstep(setup.jstate, jax.tree.map(jnp.asarray, batch))
    port = setup.port_model()
    state = TrainState(port, select_optimizer(setup.opt_cfg, port.parameters()))
    metrics = make_train_step()(state, batch_from_numpy(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), **GRAD_TOL)
    np.testing.assert_allclose(metrics["tasks_loss"].numpy(), np.asarray(jmetrics["tasks_loss"]),
                               **GRAD_TOL)
    _assert_params_close(port, jnew, "after one step:")


@pytest.mark.slow
@pytest.mark.parametrize("stack", STACKS)
def test_canary_on_the_cpu_meets_the_reference_thresholds(stack, tmp_path):
    """``tests/test_training_e2e.py::test_invariant_arch_convergence`` through
    the port on the CPU: 500 BCC samples (seed 7), 100 epochs, every head's
    RMSE and sample MAE under the stack's ``THRESHOLDS``."""
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.datasets import deterministic_graph_data

    cfg = stack_config(stack)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 100
    state, _, _ = run_training(copy.deepcopy(cfg), device="cpu", path=str(tmp_path),
                               samples=deterministic_graph_data(500, seed=7))
    _, _, trues, preds = run_prediction(copy.deepcopy(cfg), state, device="cpu",
                                        samples=deterministic_graph_data(500, seed=7))
    rmse_max, mae_max = THRESHOLDS[stack]
    for ihead, (t, p) in enumerate(zip(trues, preds)):
        rmse = float(np.sqrt(np.mean((t - p) ** 2)))
        mae = float(np.mean(np.abs(t - p)))
        assert rmse < rmse_max, f"{stack} head {ihead} RMSE {rmse:.4f} >= {rmse_max}"
        assert mae < mae_max, f"{stack} head {ihead} sample MAE {mae:.4f} >= {mae_max}"


def test_chip_smoke_geometric_canaries_are_the_reference_gates():
    """``chip_smoke.py``'s canaries of the four stacks carry
    ``tests/test_training_e2e.py``'s ``THRESHOLDS`` and ``ARCH_OVERRIDES``
    in the 4-head configuration of ``test_invariant_arch_convergence``."""
    import chip_smoke

    for stack in STACKS:
        n, seed, epochs, rmse, mae, held = chip_smoke.CANARIES[stack.lower()]
        assert (n, seed, epochs, held) == (500, 7, 100, None), stack
        assert (rmse, mae) == THRESHOLDS[stack], stack
        cfg = chip_smoke.canary_config(stack.lower())
        arch = cfg["NeuralNetwork"]["Architecture"]
        assert {k: arch[k] for k in ARCH_OVERRIDES[stack]} == ARCH_OVERRIDES[stack], stack
        assert arch["mpnn_type"] == stack
        assert arch["task_weights"] == [20.0, 1.0, 1.0, 1.0]
        assert cfg["NeuralNetwork"]["Training"]["batch_size"] == 16
        assert cfg["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"] == 0.01
