"""Forward parity of the port's ``HydraModel``/GIN with the JAX package's,
the flax variables loaded into the port by ``convert.load_jax_variables``.

Two configurations: the flagship graph+node GIN of ``__graft_entry__`` at a
small width, on QM9-sized molecules (a 16-graph batch has 472 node slots, so
the JAX Pallas kernel runs when enabled), and the 4-head config of
``tests/test_training_e2e.py`` on a 64-graph BCC batch (520 node slots).
Both run with the JAX package's fused-scatter flag off and on, in fp32 and
through the bf16 predict step.

Tolerances: fp32 sums and matmuls are taken in another order by XLA and by
PyTorch over four to five stacked layers, so fp32 compares at rtol 2e-5 /
atol 1e-5 (the largest difference seen is under a twentieth of that). The
bf16 step runs conv layer 0 in bf16 on both sides, where XLA and PyTorch may
round a dot product to neighbouring bf16 values (2^-8 relative); the
difference is carried through the fp32 layers after it, so bf16 compares at
rtol 2e-2 / atol 2e-2 (the largest difference seen is about 0.6 of that).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from conftest import random_molecule_samples
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.graphs.batching import collate, compute_pad_spec
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models.create import init_model
from hydragnn_tpu.preprocess import apply_variables_of_interest
from hydragnn_tpu.train.step import TrainState
from hydragnn_tpu.train.step import make_predict_step as jax_make_predict_step
from hydragnn_tpu_torch.convert import batch_from_numpy, load_jax_variables
from hydragnn_tpu_torch.train.step import make_predict_step as port_make_predict_step
from __graft_entry__ import FLAGSHIP_CONFIG

TOL = {"fp32": dict(rtol=2e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def _flagship_small():
    cfg = copy.deepcopy(FLAGSHIP_CONFIG)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=16, num_conv_layers=3)
    arch["output_heads"]["graph"].update(dim_sharedlayers=8, dim_headlayers=[16, 16])
    arch["output_heads"]["node"].update(dim_headlayers=[16, 16])
    return cfg, random_molecule_samples(16, seed=21), 16


def _four_heads():
    cfg = copy.deepcopy(FLAGSHIP_CONFIG)
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
    return cfg, deterministic_graph_data(number_configurations=64, seed=7), 64


CONFIGS = {"flagship": _flagship_small, "four_heads": _four_heads}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    """(augmented config, JAX model, variables, numpy batch, port model)."""
    cfg, samples, bs = CONFIGS[request.param]()
    samples = apply_variables_of_interest(samples, cfg)
    aug = jax_update_config(cfg, samples)
    model = jax_create_model_config(aug)
    batch = collate(samples[:bs], compute_pad_spec(samples, bs))
    assert batch.x.shape[0] >= 256, "the JAX kernel path needs >= 256 node slots"
    variables = init_model(model, batch)
    variables = tpu.random_batch_stats(tpu.jitter_params(variables, seed=1), seed=2)
    port = tpu.port_model_from_jax(aug, variables)
    return aug, model, variables, batch, port


def _real_rows(outputs, batch, cols):
    gm = np.asarray(batch.graph_mask) > 0
    nm = np.asarray(batch.node_mask) > 0
    return [np.asarray(o, np.float32)[gm if kind == "graph" else nm]
            for o, (kind, _, _) in zip(outputs, cols)]


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_matches_jax(setup, monkeypatch, fused, precision):
    from hydragnn_tpu.models.base import head_columns

    aug, model, variables, batch, port = setup
    monkeypatch.setenv("HYDRAGNN_FUSED_SCATTER", fused)
    dtype_j = jnp.float32 if precision == "fp32" else jnp.bfloat16
    dtype_p = torch.float32 if precision == "fp32" else torch.bfloat16
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=None, step=jnp.zeros((), jnp.int32))
    want = jax_make_predict_step(model, dtype_j)(state, jax.tree.map(jnp.asarray, batch))
    got = port_make_predict_step(port, dtype_p)(batch_from_numpy(batch))
    assert all(g.dtype == torch.float32 for g in got)
    cols = head_columns(model.spec)
    for ihead, (g, w) in enumerate(zip(_real_rows([t.numpy() for t in got], batch, cols),
                                       _real_rows(want, batch, cols))):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL[precision], err_msg=f"head {ihead}")


def test_bf16_step_promotes_to_fp32_after_first_norm(setup):
    """The predict step casts parameters and batch to bf16 but leaves the
    batch-norm running statistics fp32: conv layer 0 runs bf16, its feature
    norm promotes, and every later layer, the pooling and the heads run fp32
    with bf16-rounded weights, as in the JAX package."""
    aug, model, variables, batch, port = setup
    seen = {}

    def hook(name):
        def fn(mod, args, out):
            x = out[0] if isinstance(out, tuple) else out
            seen[name] = (args[0].dtype, x.dtype)
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in port.named_modules()
               if n.startswith(("graph_convs.", "feature_layers.")) and n.count(".") == 1]
    try:
        out = port_make_predict_step(port, torch.bfloat16)(batch_from_numpy(batch))
    finally:
        for h in handles:
            h.remove()
    assert seen["graph_convs.0"] == (torch.bfloat16, torch.bfloat16)
    assert seen["feature_layers.0"] == (torch.bfloat16, torch.float32)
    for i in range(1, len(port.graph_convs)):
        assert seen[f"graph_convs.{i}"] == (torch.float32, torch.float32)
    assert port.feature_layers[0].mean.dtype == torch.float32
    assert all(o.dtype == torch.float32 for o in out)


def test_flax_initialisers(setup):
    """Fresh port parameters follow flax's initialisers: truncated
    lecun-normal kernels (|w| <= 2 std, std = 1/sqrt(fan_in)), zero biases,
    GIN eps 0, BN scale 1 / bias 0 / running mean 0 / var 1."""
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.models.common import Dense

    aug = setup[0]
    a = create_model_config(copy.deepcopy(aug), device="cpu", seed=3)
    b = create_model_config(copy.deepcopy(aug), device="cpu", seed=3)
    for (na, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(pa, pb), f"seeded init must repeat: {na}"
    for name, p in a.state_dict().items():
        if name.endswith(".eps") or name.endswith(".bias") or name.endswith(".mean"):
            assert not p.any(), name
        elif name.endswith(".scale") or name.endswith(".var"):
            assert (p == 1).all(), name
    big = Dense(400, 300, generator=torch.Generator().manual_seed(0)).weight
    std = 1.0 / np.sqrt(400)
    assert float(big.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert abs(float(big.std()) - std) < 0.02 * std


def test_load_jax_variables_is_complete_and_strict(setup):
    aug, model, variables, batch, port = setup
    params = tpu.numpy_tree(variables["params"])
    stats = tpu.numpy_tree(variables["batch_stats"])
    k = params["graph_convs_0"]["nn"]["dense_0"]["kernel"]
    np.testing.assert_array_equal(port.graph_convs[0].nn.dense_0.weight.detach().numpy(), k.T)
    missing = copy.deepcopy(params)
    del missing["graph_convs_0"]["eps"]
    with pytest.raises(KeyError, match="without a flax variable"):
        load_jax_variables(port, missing, stats)
    extra = copy.deepcopy(params)
    extra["graph_convs_0"]["bogus"] = np.zeros(())
    with pytest.raises(KeyError):
        load_jax_variables(port, extra, stats)
    wrong = copy.deepcopy(params)
    wrong["graph_convs_0"]["nn"]["dense_0"]["kernel"] = k[:, :-1]
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(port, wrong, stats)
    load_jax_variables(port, params, stats)  # leave the shared fixture intact


def test_dense_promotes_like_flax():
    from hydragnn_tpu_torch.models.common import Dense

    d = Dense(3, 2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        d.weight.copy_(d.weight.to(torch.bfloat16).float())
        y32 = d(torch.ones(4, 3))
        d16 = d.to(torch.bfloat16)
        assert d16(torch.ones(4, 3)).dtype == torch.float32
        assert d16(torch.ones(4, 3, dtype=torch.bfloat16)).dtype == torch.bfloat16
        torch.testing.assert_close(d16(torch.ones(4, 3)), y32)


@pytest.mark.parametrize("override,what", [
    # edge features, GPS performer attention and GPS around every conv are
    # ported (tests/test_torch_edge_features.py, test_torch_gps_variants.py,
    # test_torch_gps_performer.py), and so is graph-attribute conditioning
    # (tests/test_torch_conditioning.py); these ids now point at what stays
    # refused, ring attention (parallelism), around the stacks and the
    # conditioning the ids name
    pytest.param({"mpnn_type": "PAINN", "edge_features": ["length"],
                  "global_attn_engine": "GPS", "global_attn_type": "ring"},
                 "GPS ring attention", id="override0-mpnn_type"),
    pytest.param({"global_attn_engine": "GPS", "global_attn_type": "ring"},
                 "GPS ring attention", id="override1-GPS"),
    pytest.param({"use_graph_attr_conditioning": True, "global_attn_engine": "GPS",
                  "global_attn_type": "ring"}, "GPS ring attention",
                 id="override2-conditioning"),
    pytest.param({"mpnn_type": "DimeNet", "global_attn_engine": "GPS",
                  "global_attn_type": "ring"}, "GPS ring attention", id="override3-DimeNet"),
    pytest.param({"mpnn_type": "PNA", "edge_features": ["length"],
                  "use_graph_attr_conditioning": True, "global_attn_engine": "GPS",
                  "global_attn_type": "ring"}, "GPS ring attention",
                 id="override4-PNA with edge features"),
])
def test_outside_the_slice_raises(setup, override, what):
    from hydragnn_tpu_torch.models import create_model_config

    aug = copy.deepcopy(setup[0])
    aug["NeuralNetwork"]["Architecture"].update(override)
    with pytest.raises(NotImplementedError, match=what):
        create_model_config(aug, device="cpu")


def test_other_heads_and_training_raise(setup):
    """Multibranch heads and variance outputs build and run now
    (``tests/test_torch_heads.py`` holds them against JAX); what still
    raises is an unknown node-head type or loss."""
    from hydragnn_tpu_torch.models import create_model_config

    aug = copy.deepcopy(setup[0])
    heads = aug["NeuralNetwork"]["Architecture"]["output_heads"]
    heads["graph"] = [heads["graph"][0], {**heads["graph"][0], "type": "branch-1"}]
    two = create_model_config(aug, device="cpu")
    assert set(two.heads_NN[0]) == {"branch-0", "branch-1"}
    out = two(batch_from_numpy(setup[3]))
    assert all(bool(torch.isfinite(o).all()) for o in out)
    aug = copy.deepcopy(setup[0])
    aug["NeuralNetwork"]["Training"]["loss_function_type"] = "GaussianNLLLoss"
    var_model = create_model_config(aug, device="cpu")
    means, variances = var_model(batch_from_numpy(setup[3]), train=True)
    assert all(bool((v >= 0).all()) for v in variances)
    tot, _ = var_model.loss((means, variances), batch_from_numpy(setup[3]))
    assert bool(torch.isfinite(tot))
    aug = copy.deepcopy(setup[0])
    aug["NeuralNetwork"]["Architecture"]["output_heads"]["node"] = [
        {"type": "branch-0", "architecture": {"type": "gnn"}}]
    with pytest.raises(ValueError, match="Unknown node head type"):
        create_model_config(aug, device="cpu")
    # the train-mode forward of the plain model, and an unknown loss
    from hydragnn_tpu_torch.models.common import get_loss

    port = copy.deepcopy(setup[4])
    out = port(batch_from_numpy(setup[3]), train=True)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    with pytest.raises(ValueError, match="Unknown loss"):
        get_loss("GaussianNLL")
