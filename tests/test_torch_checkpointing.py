"""``Training.conv_checkpointing`` in the port: each conv layer alone
recomputed in the backward (``models.common.checkpointed``), with the
gradients, the running statistics, the dropout generator and the metrics
bit-equal to the same train step without checkpointing, on the CPU.

The models are the tier-1 canary GAT (hidden 8, its attention dropout at
0.2, masks from the train state's generator) and GIN, and GPS-GIN (whose
layers hold batch norms and dropout inside the checkpointed conv: the
recompute must replay the masks and leave the running statistics as the
first pass moved them), on BCC graphs, one bf16 and one fp32 train step
from the same parameters and generator seed. The recompute is counted:
each conv's forward runs twice per checkpointed train step, once per
plain one. The JAX package's regression of the same option is
``tests/test_models_forward.py::test_conv_checkpointing_with_dropout_arch``.
"""

import copy

import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.datasets import deterministic_graph_data
from test_config import CI_CONFIG

STACKS = {
    "GAT": {"mpnn_type": "GAT", "hidden_dim": 8, "dropout": 0.2},
    "GIN": {"mpnn_type": "GIN"},
    "GPS-GIN": {"mpnn_type": "GIN", "global_attn_engine": "GPS",
                "global_attn_type": "multihead", "global_attn_heads": 2, "pe_dim": 2,
                "dropout": 0.2},
}


def trained_pair(arch: dict, dtype):
    """(plain state, checkpointed state, their metrics, conv forward calls
    per state) after one train step each from the same model and seed."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
    from hydragnn_tpu_torch.train.step import create_train_state, make_train_step

    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Architecture"].update(arch)
    cfg["NeuralNetwork"]["Training"]["batch_size"] = 8
    samples = tpu.port_samples(deterministic_graph_data(number_configurations=24, seed=7))
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=samples)
    aug = update_config(cfg, *(ld.samples for ld in loaders))
    ck = copy.deepcopy(aug)
    ck["NeuralNetwork"]["Training"]["conv_checkpointing"] = True
    states, metrics, calls = [], [], []
    for a in (aug, ck):
        model = create_model_config(a, device="cpu", seed=3)
        state = create_train_state(model, a["NeuralNetwork"]["Training"]["Optimizer"], seed=5)
        count = [0]
        for conv in model.graph_convs:
            conv.register_forward_hook(lambda *_: count.__setitem__(0, count[0] + 1))
        metrics.append(make_train_step(dtype)(state, next(iter(loaders[0]))))
        states.append(state)
        calls.append(count[0])
    assert states[1].model.spec.conv_checkpointing and not states[0].model.spec.conv_checkpointing
    return states, metrics, calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_checkpointed_step_is_bit_equal(stack, dtype):
    (plain, ckpt), (m_plain, m_ckpt), (n_plain, n_ckpt) = trained_pair(STACKS[stack], dtype)
    layers = len(plain.model.graph_convs)
    assert (n_plain, n_ckpt) == (layers, 2 * layers), "the recompute must run each conv again"
    for (name, p), q in zip(plain.model.named_parameters(), ckpt.model.parameters()):
        assert torch.equal(p.grad, q.grad), f"gradient of {name}"
        assert torch.equal(p, q), f"parameter {name}"
    for (name, b), c in zip(plain.model.named_buffers(), ckpt.model.buffers()):
        assert torch.equal(b, c), f"running statistic {name}"
    assert torch.equal(plain.generator.get_state(), ckpt.generator.get_state())
    for key in ("loss", "tasks_loss"):
        assert torch.equal(m_plain[key], m_ckpt[key]), key


def test_dropout_masks_act_under_checkpointing():
    """The GAT's dropout draws: two generator seeds give other gradients,
    so the bit-equality above holds with masks that matter."""
    from hydragnn_tpu_torch.models.common import Dropout, checkpointed

    x = torch.randn(64, 6, requires_grad=True)
    drop = Dropout(0.5)
    grads = []
    for seed in (0, 0, 1):
        x.grad = None
        gen = torch.Generator().manual_seed(seed)
        y = checkpointed(lambda t: drop(t * 2.0, True, gen), x)
        y.sum().backward()
        grads.append(x.grad.clone())
    assert torch.equal(grads[0], grads[1])
    assert not torch.equal(grads[0], grads[2])
    # the mask the backward used is the forward's: the gradient is 4 where
    # the output kept the entry, 0 where it dropped it
    gen = torch.Generator().manual_seed(0)
    x.grad = None
    y = checkpointed(lambda t: drop(t * 2.0, True, gen), x)
    y.sum().backward()
    assert torch.equal(x.grad != 0, y.detach() != 0)
