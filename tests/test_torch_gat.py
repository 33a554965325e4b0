"""The port's GAT (``hydragnn_tpu_torch.models.gat``) against the JAX
package's, from the same parameters (the JAX model's, converted) on the
same batches, on the CPU.

The configuration is the 4-head canary of ``tests/test_training_e2e.py``
(graph sum + three node heads; ``tests/test_config.py`` ``CI_CONFIG``) with
``mpnn_type`` GAT at hidden 8 and 2 conv layers: layer 0 concatenates its 6
heads (48 features), layer 1 averages them. The gradient and optimizer
checks run with ``dropout`` 0, the one setting under which both packages
compute the same function (their random bits differ); dropout itself is
checked for its keep rate and scaling.

Tolerances, with their reasons: fp32 forward and gradients at rtol 1e-4 /
atol 1e-5, XLA and PyTorch summing in other orders through the softmax, the
aggregation, batch norm and the heads; parameters after an AdamW step as in
``tests/test_torch_train_step.py`` (``1e-3 * lr``, and ``2 * lr`` where the
gradient is fp32 noise). The bf16 predict step runs conv layer 0 in bf16 on
both sides, where the two may round to neighbouring bf16 values (2^-8
relative) and the JAX aggregation sums in bf16 while the port's kernel sums
in fp32 (ROADMAP queue C): rtol / atol 3e-2.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.train.step import TrainState as JaxTrainState
from hydragnn_tpu.train.step import make_predict_step as jax_make_predict_step
from hydragnn_tpu_torch import run_prediction
from hydragnn_tpu_torch.convert import batch_from_numpy
from hydragnn_tpu_torch.models.common import Dropout
from hydragnn_tpu_torch.serve import PredictionServer, ServingConfig
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.step import TrainState, make_predict_step, make_train_step
from test_torch_train_step import (
    Setup,
    _assert_params_close,
    _jax_grads,
    _port_grads,
    four_head_config,
)

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def gat_config(dropout: float = 0.0) -> dict:
    cfg = four_head_config()
    cfg["NeuralNetwork"]["Architecture"].update(mpnn_type="GAT", hidden_dim=8,
                                                num_conv_layers=2, dropout=dropout)
    return cfg


@pytest.fixture(scope="module")
def setup():
    return Setup(gat_config())


def _real_rows(outputs, batch, kinds):
    gm = np.asarray(batch.graph_mask) > 0
    nm = np.asarray(batch.node_mask) > 0
    return [np.asarray(o, np.float32)[gm if k == "graph" else nm] for o, k in zip(outputs, kinds)]


def test_gat_layout_matches_jax(setup):
    """The extended edge layout is the JAX GAT's, index for index, and the
    port's widths follow the reference (6 heads concatenated, then
    averaged)."""
    from hydragnn_tpu.ops.fused_softmax import self_loop_pad

    batch = setup.batches[0]
    n, e = batch.x.shape[0], batch.senders.shape[0]
    pad = np.full(self_loop_pad(e), n - 1, np.int32)
    loop = np.arange(n, dtype=np.int32)
    s, r = batch_from_numpy(batch).self_loop_edges()
    np.testing.assert_array_equal(s.numpy(), np.concatenate([batch.senders, pad, loop]))
    np.testing.assert_array_equal(r.numpy(), np.concatenate([batch.receivers, pad, loop]))
    port = setup.port_model()
    assert port.graph_convs[0].lin_l.weight.shape == (48, 1)
    assert port.graph_convs[1].lin_l.weight.shape == (48, 48)
    assert port.feature_layers[0].scale.shape == (48,)
    assert port.feature_layers[1].scale.shape == (8,)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_gat_forward_matches_jax(setup, precision):
    """The predict step, with moved parameters and non-trivial running
    statistics."""
    from hydragnn_tpu.models.base import head_columns

    variables = tpu.random_batch_stats(tpu.jitter_params(
        {"params": setup.jstate.params, "batch_stats": setup.jstate.batch_stats}, seed=1), seed=2)
    batch = setup.batches[1]
    dtype_j, dtype_p = ((jnp.float32, torch.float32) if precision == "fp32"
                        else (jnp.bfloat16, torch.bfloat16))
    jstate = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=None, step=jnp.zeros((), jnp.int32))
    want = jax_make_predict_step(setup.jmodel, dtype_j)(jstate, jax.tree.map(jnp.asarray, batch))
    port = setup.port_model(variables["params"], variables["batch_stats"])
    got = make_predict_step(port, dtype_p)(batch_from_numpy(batch))
    kinds = [k for k, _, _ in head_columns(setup.jmodel.spec)]
    tol = TOL if precision == "fp32" else BF16_TOL
    for ihead, (g, w) in enumerate(zip(_real_rows([t.numpy() for t in got], batch, kinds),
                                       _real_rows(want, batch, kinds))):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **tol, err_msg=f"head {ihead}")


def test_gat_gradients_match_jax(setup):
    """Loss, per-task losses, every parameter's gradient (``lin_l``,
    ``lin_r``, ``att`` through the segment softmax's VJP) and the updated
    running statistics of one train-mode forward and backward."""
    batch = setup.batches[0]
    j_loss, j_tasks, j_grads, j_stats = _jax_grads(setup, batch)
    port = setup.port_model()
    p_loss, p_tasks, p_grads = _port_grads(port, batch)
    np.testing.assert_allclose(p_loss, j_loss, **TOL)
    np.testing.assert_allclose(p_tasks, j_tasks, **TOL)
    assert set(p_grads) == set(j_grads)
    assert {"graph_convs.0.att", "graph_convs.1.lin_r.weight"} <= set(p_grads)
    for name, g in p_grads.items():
        np.testing.assert_allclose(g, j_grads[name], **TOL, err_msg=name)
    for name, v in port.state_dict().items():
        if name in j_stats:
            np.testing.assert_allclose(v.numpy(), j_stats[name], **TOL, err_msg=name)


def test_gat_one_adamw_step_matches_optax(setup):
    batch = setup.batches[0]
    jnew, jmetrics = setup.jstep(setup.jstate, jax.tree.map(jnp.asarray, batch))
    port = setup.port_model()
    state = TrainState(port, select_optimizer(setup.opt_cfg, port.parameters()))
    metrics = make_train_step()(state, batch_from_numpy(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), **TOL)
    _assert_params_close(port, jnew, "GAT after one step:")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_gather_rows_matches_indexing(setup, dtype):
    """GAT's gather of node features onto the extended entries: the
    forward is ``x[ids]``; the gradient sums ``dy`` by id in fp32 (an fp32
    ``index_add_`` here) and is cast once to ``x``'s dtype."""
    from hydragnn_tpu_torch.ops.fused_scatter import gather_rows

    b = batch_from_numpy(setup.batches[0])
    senders, _ = b.self_loop_edges()
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(b.num_nodes, 6, 8, generator=gen).to(dtype).requires_grad_()
    dy = torch.randn(senders.shape[0], 6, 8, generator=gen).to(dtype)
    got = gather_rows(x, senders)
    assert torch.equal(got, x.detach()[senders.long()])
    got.backward(dy)
    want = torch.zeros(x.shape).index_add_(0, senders.long(), dy.float()).to(dtype)
    assert x.grad.dtype == dtype
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)


def test_dropout_keeps_one_minus_rate_and_scales():
    """flax's semantics: keep with probability 1 - rate, scale kept entries
    by 1 / (1 - rate), zero the rest; identity outside train mode."""
    drop = Dropout(0.25)
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = drop(x, train=True, generator=gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.75))
    assert torch.equal(drop(x, train=False), x)
    assert torch.equal(Dropout(0.0)(x, train=True), x)
    again = drop(x, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, again), "the mask is a function of the generator's state"
    with pytest.raises(ValueError, match="Generator"):
        drop(x, train=True)
    xb = torch.ones(8, dtype=torch.bfloat16)
    assert drop(xb, train=True, generator=gen).dtype == torch.bfloat16


def test_gat_train_step_draws_attention_dropout_from_the_state(setup):
    """With the default dropout (0.25) the train step draws GAT's attention
    masks from the train state's generator: the same seed gives the same
    step, another seed another."""
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.step import create_train_state

    aug = copy.deepcopy(setup.aug)
    aug["NeuralNetwork"]["Architecture"]["dropout"] = 0.25
    batch = batch_from_numpy(setup.batches[0])
    losses = []
    for seed in (3, 3, 4):
        model = create_model_config(copy.deepcopy(aug), device="cpu", seed=0)
        assert model.spec.dropout == 0.25
        state = create_train_state(model, setup.opt_cfg, seed=seed)
        losses.append(float(make_train_step()(state, batch)["loss"]))
    assert losses[0] == losses[1] and losses[0] != losses[2]


def test_checkpoint_continues_the_dropout_masks(setup, tmp_path):
    """A run restored from a checkpoint draws the attention masks an
    uninterrupted run draws next, not the first step's again: the
    checkpoint carries the dropout generator's state."""
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from hydragnn_tpu_torch.train.step import create_train_state

    aug = copy.deepcopy(setup.aug)
    aug["NeuralNetwork"]["Architecture"]["dropout"] = 0.25
    batch = batch_from_numpy(setup.batches[0])
    step = make_train_step()

    def fresh():
        return create_train_state(create_model_config(copy.deepcopy(aug), device="cpu", seed=0),
                                  setup.opt_cfg, seed=3)

    whole = fresh()
    step(whole, batch)
    save_checkpoint(whole, "drop", 0, path=str(tmp_path))
    saved = whole.generator.get_state()
    want = float(step(whole, batch)["loss"])

    resumed = fresh()
    assert not torch.equal(resumed.generator.get_state(), saved)
    load_checkpoint(resumed, "drop", path=str(tmp_path))
    assert torch.equal(resumed.generator.get_state(), saved)
    assert float(step(resumed, batch)["loss"]) == want
    for (name, a), b in zip(whole.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_gat_cpu_serving_matches_run_prediction(setup):
    """Served answers equal ``run_prediction``'s on the same padded batches
    (fp32, CPU: the same predict core), and the port's ``run_prediction``
    matches the JAX package's from the same converted state."""
    from hydragnn_tpu.datasets import deterministic_graph_data
    from hydragnn_tpu.run_prediction import run_prediction as jax_run_prediction
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = gat_config()
    samples = deterministic_graph_data(number_configurations=100, seed=7)
    model = setup.port_model()
    ps = tpu.port_samples(samples)
    _, _, trues, preds = run_prediction(copy.deepcopy(cfg), model, samples=ps, device="cpu")
    jstate = JaxTrainState(params=setup.jstate.params, batch_stats=setup.jstate.batch_stats,
                           opt_state=None, step=jnp.zeros((), jnp.int32))
    _, _, _, jpreds = jax_run_prediction(copy.deepcopy(cfg), jstate, setup.jmodel,
                                         samples=tpu.jax_samples_copy(samples))
    for pj, pp in zip(jpreds, preds):
        np.testing.assert_allclose(pp, np.asarray(pj), **TOL)
    _, _, test_loader = dataset_loading_and_splitting(copy.deepcopy(cfg),
                                                      samples=tpu.port_samples(samples))
    server = PredictionServer(ServingConfig(flush_ms=250.0), device="cpu")
    server.add_model("gat", model, setup.aug, samples=test_loader.samples,
                     buckets=[test_loader.pad])
    server.start()
    try:
        served = [[] for _ in preds]
        for chunk, _pad in test_loader.batch_plan():
            results = [f.result(timeout=60.0) for f in
                       [server.submit("gat", test_loader.samples[i]) for i in chunk]]
            for ihead in range(len(preds)):
                served[ihead].extend(np.atleast_1d(r["heads"][ihead]) for r in results)
    finally:
        server.stop()
    for ihead, want in enumerate(preds):
        got = np.concatenate([a.reshape(-1, want.shape[1]) for a in served[ihead]])
        assert np.array_equal(got, want), f"head {ihead}: served != run_prediction"


def test_gat_with_edge_features_waits_for_its_slice(setup):
    from hydragnn_tpu_torch.models import create_model_config

    aug = copy.deepcopy(setup.aug)
    aug["NeuralNetwork"]["Architecture"]["edge_features"] = ["length"]
    with pytest.raises(NotImplementedError, match="lin_edge"):
        create_model_config(aug, device="cpu")
