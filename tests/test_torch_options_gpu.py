"""This slice's options on the card, against the port's CPU route and
against themselves: ``conv_checkpointing`` (GAT with its dropout at 0.2,
and the GIN) bit-equal to the plain train step, eager and captured; the
six optax optimizers' captured steps bit-equal to their eager steps, and
one step against the CPU route; the conditioned, variance, per-node,
conv-head and multibranch models' forward and gradients against the CPU
route. The models are the tier-1 canary configuration of
``tests/test_config.py`` (hidden 8, 2 conv layers; written out here, the
card's machine has no JAX) on BCC graphs.

Bounds against the CPU route: outputs within rtol 1e-4 / atol 1e-5 (fp32
sums in another order, ``chip_smoke.CPU_PARITY``); gradients held, as
``chip_smoke.py``'s fp32 step check holds them, against an fp64 run of
the same step on the CPU: the card's error per tensor within 8 x the
largest of the CPU route's own error, 1e-5 of the tensor's largest fp64
gradient and 1e-7 of the model's (a gradient that is 0 in exact
arithmetic, such as a bias's in front of a batch norm, is rounding noise
on both sides); the optimizers' updated parameters by
``chip_smoke.optimizer_step_vs_cpu`` (``CPU_PARITY`` where the gradient
is signal, both steps together where it is noise).

Every test is ``gpu``-marked and skips without a CUDA device:

    python -m pytest tests/test_torch_options_gpu.py -m gpu --noconftest -q
"""

import copy

import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu_torch import capture
from hydragnn_tpu_torch.graphs.batching import collate

pytestmark = pytest.mark.gpu

CPU_PARITY = dict(rtol=1e-4, atol=1e-5)
CI = {
    "Verbosity": {"level": 0},
    "Dataset": {"name": "unit_test_singlehead", "format": "unit_test",
                "node_features": {"name": ["type", "x", "x2", "x3"], "dim": [1, 1, 1, 1],
                                  "column_index": [0, 1, 2, 3]},
                "graph_features": {"name": ["sum"], "dim": [1], "column_index": [0]}},
    "NeuralNetwork": {
        "Architecture": {"mpnn_type": "GIN", "radius": 2.0, "max_neighbours": 100,
                         "hidden_dim": 8, "num_conv_layers": 2,
                         "output_heads": {"graph": {"num_sharedlayers": 2,
                                                    "dim_sharedlayers": 4,
                                                    "num_headlayers": 2,
                                                    "dim_headlayers": [10, 10]}},
                         "task_weights": [1.0], "activation_function": "silu"},
        "Variables_of_interest": {"input_node_features": [0], "output_names": ["sum"],
                                  "output_index": [0], "type": ["graph"],
                                  "denormalize_output": False},
        "Training": {"num_epoch": 1, "perc_train": 0.7, "loss_function_type": "mse",
                     "batch_size": 16, "Optimizer": {"type": "AdamW", "learning_rate": 0.02}},
    },
}
NODE = {"voi": {"input_node_features": [0], "output_names": ["sum", "x"],
                "output_index": [0, 1], "type": ["graph", "node"],
                "denormalize_output": False},
        "head": {"num_headlayers": 2, "dim_headlayers": [4, 4]}}


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _option_config(option: str) -> tuple[dict, dict]:
    """(config, deterministic_graph_data keywords) of one option."""
    cfg = copy.deepcopy(CI)
    arch = cfg["NeuralNetwork"]["Architecture"]
    data = {}
    if option in ("film", "concat_node", "fuse_pool"):
        arch.update(use_graph_attr_conditioning=True, graph_attr_conditioning_mode=option)
    elif option == "gaussian_nll":
        cfg["NeuralNetwork"]["Training"]["loss_function_type"] = "GaussianNLLLoss"
    elif option in ("mlp_per_node", "conv", "conv_gat"):
        cfg["NeuralNetwork"]["Variables_of_interest"] = copy.deepcopy(NODE["voi"])
        arch["task_weights"] = [1.0, 1.0]
        arch["output_heads"]["node"] = {**NODE["head"],
                                        "type": "conv" if option == "conv_gat" else option}
        if option == "conv_gat":
            arch.update(mpnn_type="GAT", dropout=0.0)
        if option == "mlp_per_node":
            data = {"unit_cell_x_range": (2, 3), "unit_cell_y_range": (2, 3)}
    elif option == "branches":
        graph = arch["output_heads"]["graph"]
        arch["output_heads"]["graph"] = [{"type": f"branch-{i}", "architecture": dict(graph)}
                                         for i in range(2)]
    return cfg, data


def _loaders(cfg, data, seed: int = 7, n: int = 48):
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.datasets import deterministic_graph_data
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    samples = deterministic_graph_data(n, seed=seed, **data)
    rng = np.random.default_rng(seed)
    for i, s in enumerate(samples):
        s.graph_attr = rng.normal(size=(2,)).astype(np.float32)
        s.dataset_id = i % 2
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=samples)
    return update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders)), loaders


OPTIONS = ["film", "concat_node", "fuse_pool", "gaussian_nll", "mlp_per_node", "conv",
           "conv_gat", "branches"]


@pytest.mark.parametrize("option", OPTIONS)
def test_option_model_card_vs_cpu(option):
    """Eval outputs (means and variances) and the fp32 train-mode
    gradients of one model on the card against the CPU route from the same
    parameters."""
    _cuda_or_skip()
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.step import cast_forward, make_predict_step

    cfg, data = _option_config(option)
    aug, loaders = _loaders(cfg, data)
    host = collate(loaders[0].samples[:16], loaders[0].pad)
    results = []
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        model = create_model_config(aug, device=device, seed=3).to(dtype)
        b = collate(loaders[0].samples[:16], loaders[0].pad).to(device)
        b = b.map_floats(lambda t: t.to(dtype))
        out = tpu.flat_outputs(make_predict_step(model, dtype)(b))
        b = collate(loaders[0].samples[:16], loaders[0].pad).to(device)
        b = b.map_floats(lambda t: t.to(dtype))
        model.zero_grad()
        tot, _ = model.loss(cast_forward(model, b, dtype, train=True), b)
        tot.backward()
        results.append(([o.cpu() for o in out],
                        {n: p.grad.cpu().double() for n, p in model.named_parameters()
                         if p.grad is not None}))
    (out_c, g_c), (out_h, g_h), (_, g64) = results
    for a, c in zip(out_c, out_h):
        torch.testing.assert_close(a, c, **CPU_PARITY)
    assert set(g_c) == set(g_h) == set(g64)
    model_max = max(float(g.abs().max()) for g in g64.values())
    for name, ref in g64.items():
        card_err = float((g_c[name] - ref).abs().max())
        cpu_err = float((g_h[name] - ref).abs().max())
        bound = 8 * max(cpu_err, 1e-5 * float(ref.abs().max()), 1e-7 * model_max)
        assert card_err <= bound, (f"{option} {name}: card {card_err:.3e}, CPU {cpu_err:.3e} "
                                   f"from fp64 (allowed {bound:.3e})")


@pytest.mark.parametrize("stack", ["GAT", "GIN"])
def test_checkpointed_steps_bit_equal_on_card(stack):
    """One bf16 train step with and without ``conv_checkpointing`` from the
    same parameters and generator, eagerly and as a captured graph:
    gradients, parameters, running statistics, generator and metrics bit
    for bit (the recompute replays the first pass's dropout masks)."""
    _cuda_or_skip()
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.step import create_train_state, make_train_step

    cfg = copy.deepcopy(CI)
    cfg["NeuralNetwork"]["Architecture"].update(mpnn_type=stack, dropout=0.2)
    aug, loaders = _loaders(cfg, {})
    ck = copy.deepcopy(aug)
    ck["NeuralNetwork"]["Training"]["conv_checkpointing"] = True
    host = collate(loaders[0].samples[:16], loaders[0].pad)
    step = make_train_step(torch.bfloat16)
    for captured in (False, True):
        runs = []
        for a in (aug, ck):
            model = create_model_config(a, device="cuda", seed=3)
            state = create_train_state(model, a["NeuralNetwork"]["Training"]["Optimizer"],
                                       seed=5)
            run = capture.Dispatch(step, "train", train=True) if captured else step
            metrics = run(state, host.to("cuda"))
            runs.append((state, metrics, [p.grad.clone() for p in model.parameters()]))
        (s0, m0, g0), (s1, m1, g1) = runs
        assert all(torch.equal(x, y) for x, y in zip(g0, g1)), f"captured {captured}"
        for x, y in zip(s0.model.state_dict().values(), s1.model.state_dict().values()):
            assert torch.equal(x, y)
        assert torch.equal(s0.generator.get_state(), s1.generator.get_state())
        assert torch.equal(m0["loss"], m1["loss"])


@pytest.mark.parametrize("opt_type", ["RMSProp", "Adagrad", "Adadelta", "Adamax", "LAMB",
                                      "FusedLAMB"])
def test_optax_optimizer_on_card(opt_type):
    """Three captured train steps bit-equal to three eager steps from
    copies of one state (the learning rate halved before the third); one
    fp32 step against the CPU route (``chip_smoke.optimizer_step_vs_cpu``)."""
    _cuda_or_skip()
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.optimizer import set_learning_rate
    from hydragnn_tpu_torch.train.step import create_train_state, make_train_step

    cfg = copy.deepcopy(CI)
    cfg["NeuralNetwork"]["Training"]["Optimizer"] = {"type": opt_type, "learning_rate": 0.01}
    aug, loaders = _loaders(cfg, {})
    opt_cfg = aug["NeuralNetwork"]["Training"]["Optimizer"]
    host = collate(loaders[0].samples[:16], loaders[0].pad)
    step = make_train_step(torch.bfloat16)
    states = [create_train_state(create_model_config(aug, device="cuda", seed=3), opt_cfg)
              for _ in range(2)]
    graph = capture.Dispatch(step, "train", train=True)
    for i in range(3):
        if i == 2:
            for s in states:
                set_learning_rate(s.optimizer, 0.005)
        graph(states[0], host.to("cuda"))
        step(states[1], host.to("cuda"))
        for x, y in zip(states[0].model.parameters(), states[1].model.parameters()):
            assert torch.equal(x, y), f"step {i}"
        for sa, sb in zip(states[0].optimizer.state.values(), states[1].optimizer.state.values()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
    import chip_smoke

    chip_smoke.optimizer_step_vs_cpu(torch, aug, host, "cuda", 3)
