"""The port's other head options against the JAX package on the CPU:
variance outputs (``GaussianNLLLoss``), ``mlp_per_node`` and ``conv``
node heads, and multibranch graph and node heads; eval and train outputs
(means and variances), loss, running statistics and every parameter
gradient from the same parameters.

The models are the tier-1 canary GIN (``tests/test_config.py``
``CI_CONFIG``: hidden 8, 2 conv layers), with a graph head and a node head
(``x``, the second node feature) where a node head is needed, dropout 0,
on BCC graphs of ``deterministic_graph_data``; ``mlp_per_node`` on graphs
of one size (2 x 2 x 1 BCC cells, 8 atoms). The parameters are the port's
draw, jittered and written into the JAX model's variables
(``torch_port_util.PairSetup``), then carried back.

Bounds: the GIN's fp32 bounds of ``test_torch_edge_features.py`` (forward
rtol 2e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-6); the heads are
Dense layers, einsums over the gathered weight banks and conv layers,
summed in another order by XLA and PyTorch. Where the gradients grow, the
gradients' atol grows with the model's largest gradient: by 1e-5 of it
under GaussianNLLLoss (the division by the variances: the largest
gradient is 565-1,227 where the MSE model's is 0.45; the port misses JAX
by at most 3.5e-6 of it, on a bias in front of a batch norm, 0 in exact
arithmetic), by 5e-5 under conv node heads (conv layers without a norm
after the encoder, GIN's neighbour sums growing the activations: largest
gradient 29; the port misses JAX by 1.7e-5 of it).
"""

import copy

import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.datasets import deterministic_graph_data
from test_config import CI_CONFIG

FWD_TOL = dict(rtol=2e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
VAR_GRAD_SCALE = 1e-5
CONV_GRAD_SCALE = 5e-5
NODE_VOI = {"input_node_features": [0], "output_names": ["sum", "x"], "output_index": [0, 1],
            "type": ["graph", "node"], "denormalize_output": False}


def head_config(stack: str = "GIN", node_type: str | None = None, loss: str = "mse",
                **arch) -> dict:
    cfg = copy.deepcopy(CI_CONFIG)
    a = cfg["NeuralNetwork"]["Architecture"]
    a.update(mpnn_type=stack, dropout=0.0, activation_function="silu", **arch)
    if node_type is not None:
        cfg["NeuralNetwork"]["Variables_of_interest"] = copy.deepcopy(NODE_VOI)
        a["task_weights"] = [1.0, 1.0]
        a["output_heads"]["node"] = {"num_headlayers": 2, "dim_headlayers": [4, 4],
                                     "type": node_type}
    cfg["NeuralNetwork"]["Training"].update(batch_size=8, loss_function_type=loss)
    return cfg


def bcc(n: int = 24, fixed: bool = False):
    cell = dict(unit_cell_x_range=(2, 3), unit_cell_y_range=(2, 3)) if fixed else {}
    return deterministic_graph_data(number_configurations=n, seed=7, **cell)


def test_gaussian_nll_matches_jax():
    """``masked_gaussian_nll`` against the JAX package's on the same
    arrays, with padding rows and variances below the 1e-6 floor; its
    gradients in the means and variances against ``jax.grad``."""
    import jax
    import jax.numpy as jnp

    from hydragnn_tpu.models.common import masked_gaussian_nll as jax_nll
    from hydragnn_tpu_torch.models.common import get_loss

    rng = np.random.default_rng(3)
    pred, target = rng.normal(size=(2, 10, 3)).astype(np.float32)
    var = rng.uniform(0.0, 2.0, size=(10, 3)).astype(np.float32)
    var[0, 0] = 1e-8
    mask = (np.arange(10) < 7).astype(np.float32)
    want, (g_mu, g_var) = jax.value_and_grad(jax_nll, argnums=(0, 3))(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask), jnp.asarray(var))
    mu_t = torch.tensor(pred, requires_grad=True)
    var_t = torch.tensor(var, requires_grad=True)
    got = get_loss("GaussianNLLLoss")(mu_t, torch.tensor(target), torch.tensor(mask), var_t)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(mu_t.grad.numpy(), np.asarray(g_mu), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(var_t.grad.numpy(), np.asarray(g_var), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("node_type", [pytest.param(None, marks=pytest.mark.slow), "mlp"],
                         ids=["graph_head", "graph_and_node"])
def test_variance_outputs_match_jax(node_type):
    setup = tpu.PairSetup(head_config(node_type=node_type, loss="GaussianNLLLoss"), bcc())
    assert setup.spec.var_output
    setup.assert_matches("fp32", FWD_TOL, GRAD_TOL, f"var_output {node_type}",
                         grad_scale=VAR_GRAD_SCALE)
    # the variances are squares: non-negative, and not all zero
    var = setup.port()["outputs"][len(setup.spec.output_dim):]
    assert all((v >= 0).all() and v.any() for v in var)


def test_predictor_drops_the_variances():
    """``Predictor.outputs`` answers the means only, as the JAX
    ``Predictor`` does; the eval step's squared errors are the means'."""
    from hydragnn_tpu_torch.convert import batch_from_numpy
    from hydragnn_tpu_torch.serve import Predictor
    from hydragnn_tpu_torch.train.step import make_predict_step

    setup = tpu.PairSetup(head_config(node_type="mlp", loss="GaussianNLLLoss"), bcc())
    model = setup.port_model()
    b = batch_from_numpy(setup.batch)
    means, variances = make_predict_step(model)(b)
    out = Predictor(model, setup.aug, device="cpu").outputs(b)
    assert len(out) == 2 and all(torch.equal(o, m) for o, m in zip(out, means))
    sses, _ = model.head_sse((means, variances), b)
    want = ((means[0] - b.graph_y[:, :1]) ** 2 * b.graph_mask[:, None]).sum()
    assert torch.equal(sses[0], want)


def test_mlp_per_node_matches_jax():
    setup = tpu.PairSetup(head_config(node_type="mlp_per_node"), bcc(fixed=True))
    assert setup.spec.num_nodes == 8 and not setup.spec.graph_size_variable
    model = setup.port_model()
    bank = model.heads_NN[1]["branch-0"].w_0
    assert tuple(bank.shape) == (8, setup.spec.hidden_dim, 4)
    setup.assert_matches("fp32", FWD_TOL, GRAD_TOL, "mlp_per_node")


def test_mlp_per_node_refuses_variable_size_graphs():
    from hydragnn_tpu.config import update_config as jax_update_config
    from hydragnn_tpu_torch.config import update_config

    samples = bcc()
    assert len({s.num_nodes for s in samples}) > 1
    for fn, s in ((jax_update_config, tpu.jax_samples_copy(samples)),
                  (update_config, tpu.port_samples(samples))):
        with pytest.raises(ValueError, match="mlp_per_node"):
            fn(head_config(node_type="mlp_per_node"), s)


@pytest.mark.slow
def test_mlp_per_node_stays_fp32_bank_under_bf16():
    """bf16 steps: the per-node einsum promotes the features and the cast
    bank to their common type, as ``jnp.einsum`` does; the outputs follow
    the JAX bf16 forward within the GIN's bf16 bounds widened by JAX's own
    bf16 distance from its fp32 forward."""
    setup = tpu.PairSetup(head_config(node_type="mlp_per_node"), bcc(fixed=True))
    got, want, want32 = setup.port("bf16"), setup.jax("bf16"), setup.jax("fp32")
    for g, w, w32 in zip(setup.head_rows(got["outputs"]), setup.head_rows(want["outputs"]),
                         setup.head_rows(want32["outputs"])):
        tpu.assert_within_jax_bf16_gap(g, w, w32, rtol=2e-2, atol=2e-2, what="bf16 per-node")


@pytest.mark.parametrize("stack", ["GIN", pytest.param("GAT", marks=pytest.mark.slow)])
def test_conv_node_heads_match_jax(stack):
    arch = {"hidden_dim": 8} if stack == "GAT" else {}
    setup = tpu.PairSetup(head_config(stack, node_type="conv", **arch), bcc())
    model = setup.port_model()
    head = model.heads_NN[1]["branch-0"]
    assert {n.split(".")[0] for n, _ in head.named_parameters()} == {"conv0", "conv1",
                                                                      "convout"}
    setup.assert_matches("fp32", FWD_TOL, GRAD_TOL, f"{stack} conv head",
                         grad_scale=CONV_GRAD_SCALE)


def _branch_samples(n: int, node_dim: int = 0, seed: int = 5):
    samples = deterministic_graph_data(number_configurations=n, seed=seed)
    for i, s in enumerate(samples):
        s.dataset_id = i % 2
        if node_dim:
            s.node_y = np.random.default_rng(i).normal(size=(s.num_nodes, node_dim)).astype(
                np.float32)
            s.extras = {}
    return samples


def _branches(arch: dict) -> list[dict]:
    return [{"type": f"branch-{i}", "architecture": dict(arch)} for i in range(2)]


@pytest.mark.parametrize("var", [False, pytest.param(True, marks=pytest.mark.slow)],
                         ids=["mse", "gaussian_nll"])
def test_multibranch_graph_heads_match_jax(var):
    cfg = head_config(loss="GaussianNLLLoss" if var else "mse")
    cfg["NeuralNetwork"]["Architecture"]["output_heads"] = {"graph": _branches(
        {"num_sharedlayers": 1, "dim_sharedlayers": 4, "num_headlayers": 2,
         "dim_headlayers": [10, 10]})}
    setup = tpu.PairSetup(cfg, _branch_samples(12), raw_batch=8)
    assert sorted(np.asarray(setup.batch.dataset_id)[:8]) == [0] * 4 + [1] * 4
    setup.assert_matches("fp32", FWD_TOL, GRAD_TOL, "multibranch graph",
                         grad_scale=VAR_GRAD_SCALE if var else 0.0)
    # each branch answers its own graphs: branch 1's weights move branch-1
    # rows only
    from hydragnn_tpu_torch.convert import batch_from_numpy
    from hydragnn_tpu_torch.train.step import head_means, make_predict_step

    model = setup.port_model()
    b = batch_from_numpy(setup.batch)
    before = head_means(model, make_predict_step(model)(b))[0]
    with torch.no_grad():
        model.heads_NN[0]["branch-1"].dense_2.bias.add_(1.0)
    after = head_means(model, make_predict_step(model)(b))[0]
    ids = b.dataset_id
    real = b.graph_mask > 0
    assert torch.equal(before[(ids == 0) & real], after[(ids == 0) & real])
    assert not torch.equal(before[(ids == 1) & real], after[(ids == 1) & real])


@pytest.mark.parametrize("dim", [pytest.param(1, marks=pytest.mark.slow), 3])
def test_multibranch_node_heads_match_jax(dim):
    """Two node-head branches (the JAX package's
    ``test_multibranch_multidim_head``, output_dim 1 and 3)."""
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Variables_of_interest"] = {
        "input_node_features": [0], "output_index": [0], "type": ["node"], "output_dim": [dim]}
    a = cfg["NeuralNetwork"]["Architecture"]
    a.update(task_weights=[1.0], dropout=0.0, activation_function="silu",
             output_heads={"node": _branches({"num_headlayers": 1, "dim_headlayers": [4],
                                              "type": "mlp"})})
    setup = tpu.PairSetup(cfg, _branch_samples(6, node_dim=dim), raw_batch=4)
    setup.assert_matches("fp32", FWD_TOL, GRAD_TOL, f"multibranch node dim {dim}")
    assert setup.port()["outputs"][0].shape == (setup.batch.num_nodes, dim)
