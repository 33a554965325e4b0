"""GPS performer attention in the port against the JAX package on the CPU,
and one AdamW step of ``chip_smoke.py``'s three full-width kinds.

* Performer (GPS-GIN fp32 and bf16, GPS-PNA with edge features fp32):
  forward and every parameter gradient with the JAX package's projections
  loaded; graph locality; FAVOR+ approximating softmax attention
  (``tests/test_gps.py:202-250``); the projection kept as a buffer of the
  state dict and checkpoints.
* One AdamW step of ``gat_edge``, ``gps_pna_edge`` and ``gps_performer`` at
  the canary's widths against optax (fp32).

Configurations, parameters and tolerances as in
``tests/test_torch_edge_features.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.step import TrainState as JaxTrainState
from hydragnn_tpu.train.step import make_train_step as jax_make_train_step
from hydragnn_tpu_torch.convert import batch_from_numpy
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.step import TrainState, make_train_step
from test_torch_edge_features import GRAD_TOL, Setup, check_forward, check_gradients, stack_config
from test_torch_train_step import _assert_params_close


# -- performer -------------------------------------------------------------------


@pytest.fixture(scope="module", params=["GIN", "PNA"])
def performer(request):
    conv = request.param
    return Setup(stack_config(conv, edge=conv == "PNA", gps="performer"))


# bf16 on the GIN only: GPS-PNA's bf16 path is PNA's, held in
# tests/test_torch_edge_features.py
@pytest.mark.parametrize("performer,precision", [("GIN", "fp32"), ("GIN", "bf16"),
                                                 ("PNA", "fp32")], indirect=["performer"])
def test_performer_matches_jax(performer, precision):
    """Forward and every parameter gradient, with the JAX package's fixed
    projections (drawn per layer at the dtype of that layer's features)
    loaded into the port's buffers."""
    conv = performer.spec.mpnn_type
    check_forward(performer, precision, conv)
    check_gradients(performer, precision, conv)


def test_performer_projection_is_a_buffer(performer, tmp_path):
    """``w`` is a per-layer buffer of the state dict, drawn from the
    model's generator (the same seed draws the same projections), kept in
    checkpoints, and not a parameter."""
    from hydragnn_tpu_torch.models import create_model_config

    model = create_model_config(copy.deepcopy(performer.aug), device="cpu", seed=3)
    again = create_model_config(copy.deepcopy(performer.aug), device="cpu", seed=3)
    other = create_model_config(copy.deepcopy(performer.aug), device="cpu", seed=4)
    names = [f"graph_convs.{i}.attn.w" for i in range(len(model.graph_convs))]
    state = model.state_dict()
    params = dict(model.named_parameters())
    dh = performer.spec.hidden_dim // 2
    for name in names:
        assert name in state and name not in params
        assert tuple(state[name].shape) == (2, dh, max(8, (dh + 7) // 8 * 8))
        assert torch.equal(state[name], again.state_dict()[name])
        assert not torch.equal(state[name], other.state_dict()[name])
    layers = [model.graph_convs[i].attn.w for i in range(len(names))]
    assert not torch.equal(layers[0], layers[1])
    torch.save(state, tmp_path / "m.pt")
    other.load_state_dict(torch.load(tmp_path / "m.pt"))
    for name in names:
        assert torch.equal(other.state_dict()[name], state[name])


def test_performer_attention_is_graph_local(performer):
    """Moving one graph's node features changes that graph's outputs only
    (``tests/test_gps.py::test_performer_attention_is_graph_local``)."""
    from hydragnn_tpu_torch.train.step import make_predict_step

    model = performer.port_model()
    pb = batch_from_numpy(performer.batch)
    out0 = make_predict_step(model)(pb)[0]
    sel = (pb.batch == 1)[:, None]
    out1 = make_predict_step(model)(pb.replace(x=torch.where(sel, pb.x + 10.0, pb.x)))[0]
    np.testing.assert_allclose(float(out0[0, 0]), float(out1[0, 0]), rtol=1e-5)
    assert abs(float(out0[1, 0]) - float(out1[1, 0])) > 1e-6


def test_performer_approximates_softmax_attention():
    """With 2,048 random features FAVOR+ comes within 15% (mean relative
    error) of exact per-graph softmax attention with the same weights
    (``tests/test_gps.py::test_performer_approximates_softmax_attention``)."""
    from hydragnn_tpu_torch.models.gps import GraphMultiheadAttention, PerformerAttention

    s = Setup(stack_config("GIN", edge=False, gps="performer"), n_samples=16)
    batch = batch_from_numpy(s.batch)
    gen = torch.Generator().manual_seed(2)
    h = 0.3 * torch.randn((batch.num_nodes, 8), generator=gen)
    exact = GraphMultiheadAttention(8, 1, 0, generator=gen)
    approx = PerformerAttention(8, 1, generator=gen, num_features=2048)
    for name in ("q", "k", "v", "out"):
        getattr(approx, name).load_state_dict(getattr(exact, name).state_dict())
    with torch.no_grad():
        out_e, out_a = exact(h, batch), approx(h, batch)
    mask = batch.node_mask > 0
    err = (out_e[mask] - out_a[mask]).abs()
    scale = out_e[mask].abs().mean() + 1e-6
    assert float(err.mean() / scale) < 0.15


# -- one AdamW step of the three full-width kinds ---------------------------------------


KINDS = {
    "gat_edge": lambda: stack_config("GAT"),
    "gps_pna_edge": lambda: stack_config("PNA", gps="multihead", global_attn_heads=4),
    "gps_performer": lambda: stack_config("GIN", edge=False, gps="performer",
                                          global_attn_heads=4),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_one_adamw_step_matches_optax(kind):
    """One AdamW step from the same state on the same batch (fp32)."""
    s = Setup(KINDS[kind](), n_samples=16)
    opt_cfg = s.jaug["NeuralNetwork"]["Training"]["Optimizer"]
    optimizer = jax_select_optimizer(opt_cfg)
    params = jax.tree.map(jnp.asarray, s.variables["params"])
    jstate = JaxTrainState(params=params,
                           batch_stats=jax.tree.map(jnp.asarray, s.variables["batch_stats"]),
                           opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32))
    jnew, jmetrics = jax_make_train_step(s.jmodel, optimizer)(
        jstate, jax.tree.map(jnp.asarray, s.batch))
    port = s.port_model()
    state = TrainState(port, select_optimizer(opt_cfg, port.parameters()))
    metrics = make_train_step()(state, batch_from_numpy(s.batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), **GRAD_TOL)
    _assert_params_close(port, jnew, f"{kind} after one step:")


@pytest.mark.slow
@pytest.mark.parametrize("name", ["gat_edge", "gps_pna_edge", "gps_performer"])
def test_new_canaries_on_the_cpu(name):
    """``chip_smoke.py``'s canaries with the options on, through the port's
    ``run_training`` and ``run_prediction`` on the CPU, at the reference
    thresholds (GAT's 0.60 / 0.70 with the edge lengths; GPS-GIN's 0.35 for
    GPS-PNA with the edge lengths and the performer). The JAX package's
    readings of the same configurations: ``tests/canary_readings.py``."""
    import chip_smoke

    chip_smoke.canary_phase(torch, "cpu", names=(name,))
