"""Training the invariant conv stacks SAGE, MFC, SchNet, PNA, PNAPlus and
CGCNN in the port against the JAX package: per stack, the train-mode
gradients (fp32 and the bf16 step) and one AdamW step from the same
parameters on the same batch, on the 4-head BCC canary configuration of
``tests/test_training_e2e.py`` (hidden 8, 2 conv layers, batch 16, lr 0.01,
the stack's ``ARCH_OVERRIDES``); and, slow-marked, each stack's canary
itself through the port's ``run_training`` on the CPU, at the reference's
``THRESHOLDS``.

Tolerances, with their reasons. Those of ``tests/test_torch_train_step.py``
for the GIN where they hold: fp32 gradients and losses rtol 1e-4 / atol
1e-6 (XLA and PyTorch sum in other orders); parameters after the step
within ``1e-3 * lr`` (``2 * lr`` where the gradients are at the fp32 noise
of a cancelling sum). Two differ:

* PNA and PNAPlus fp32 gradients: atol 1e-5. Conv layer 0 takes the std of
  messages that are often equal on the BCC lattice, where ``sqrt(var +
  1e-5)`` multiplies the rounding of ``E[x^2] - E[x]^2`` by up to 158:
  measured, layer 0's ``pre_nn`` weight gradient differs by 1.7e-6 on an
  entry of 5.4e-4, and the JAX fp32 gradient itself misses the port's fp64
  one there by 1.1e-4 of the tensor's largest entry.
* The bf16 step, with the JAX package's fused kernels on (its Pallas
  kernels sum in fp32, as the port's do): per entry, the GIN's rtol 2e-2 /
  atol 2e-3 plus the JAX step's own distance from its fp32 gradient. Where
  its kernel refuses a shape (the pooling of a 16-graph batch, G = 17) the
  JAX package sums bf16 in bf16 (ROADMAP queue C item 1), the port in fp32:
  measured, SchNet's head biases then differ by up to 2.2e-2, of which
  2.1e-2 is the JAX bf16 gradient's distance from its fp32 one (the port's
  8e-4).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hydragnn_tpu_torch.convert import batch_from_numpy
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.step import TrainState, make_train_step
from test_torch_train_step import (GRAD_TOL, Setup, _assert_params_close, _jax_grads,
                                   _port_grads, four_head_config)
from test_training_e2e import ARCH_OVERRIDES, THRESHOLDS

STACKS = ("SAGE", "MFC", "SchNet", "PNA", "PNAPlus", "CGCNN")
# PNA's and PNAPlus's fp32 gradients: the std's amplified rounding (above)
GRAD_TOL_STD = dict(rtol=1e-4, atol=1e-5)


def stack_config(stack):
    cfg = four_head_config()
    cfg["NeuralNetwork"]["Architecture"].update(mpnn_type=stack, **ARCH_OVERRIDES[stack])
    return cfg


@pytest.fixture(scope="module", params=STACKS)
def setup(request):
    return Setup(stack_config(request.param))


def test_parameter_gradients_match_jax(setup):
    """Loss, per-task losses, every parameter's gradient (MFC's banks,
    ``rbf.freq``, SchNet's filters through the per-channel weight of the
    gather-scatter) and the updated running statistics of one train-mode
    forward and backward."""
    batch = setup.batches[0]
    j_loss, j_tasks, j_grads, j_stats = _jax_grads(setup, batch)
    port = setup.port_model()
    p_loss, p_tasks, p_grads = _port_grads(port, batch)
    np.testing.assert_allclose(p_loss, j_loss, **GRAD_TOL)
    np.testing.assert_allclose(p_tasks, j_tasks, **GRAD_TOL)
    assert set(p_grads) == set(j_grads)
    tol = GRAD_TOL_STD if port.spec.mpnn_type in ("PNA", "PNAPlus") else GRAD_TOL
    for name, g in p_grads.items():
        np.testing.assert_allclose(g, j_grads[name], **tol, err_msg=name)
    for name, v in port.state_dict().items():
        if name in j_stats:
            np.testing.assert_allclose(v.numpy(), j_stats[name], **GRAD_TOL, err_msg=name)
    assert all(np.abs(g).max() > 0 for n, g in p_grads.items() if n.startswith("graph_convs.1")), \
        "every parameter of the last conv layer gets a gradient"


def test_bf16_step_gradients_match_jax(setup, monkeypatch):
    """The bf16 step: parameters and batch cast inside the differentiated
    function, fp32 gradients for the fp32 masters."""
    import torch

    monkeypatch.setenv("HYDRAGNN_FUSED_SCATTER", "1")
    batch = setup.batches[0]
    j_loss, _, j_grads, _ = _jax_grads(setup, batch, jnp.bfloat16)
    _, _, j_fp32, _ = _jax_grads(setup, batch)
    port = setup.port_model()
    p_loss, _, p_grads = _port_grads(port, batch, torch.bfloat16)
    assert all(p.grad.dtype == torch.float32 for p in port.parameters())
    np.testing.assert_allclose(p_loss, j_loss, rtol=2e-2, atol=2e-3)
    for name, g in p_grads.items():
        want = j_grads[name]
        bound = 2e-3 + 2e-2 * np.abs(want) + np.abs(want - j_fp32[name])
        excess = np.abs(g - want) - bound
        assert (excess <= 0).all(), \
            f"{name}: max |port - JAX| beyond its bound by {excess.max():.3e}"


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
