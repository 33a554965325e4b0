"""Graph-attribute conditioning in the port (``film``, ``concat_node``,
``fuse_pool``) against the JAX package on the CPU: each mode on the GIN,
EGNN, CGCNN and MACE, the eval and train outputs, loss, running statistics
and every parameter gradient from the same parameters; and, with
zero-width graph attributes, no conditioning layer and the flax tree's
names.

The model is the stack on the tier-1 canary configuration
(``tests/test_config.py`` ``CI_CONFIG``: hidden 8, 2 conv layers; the
stack's ``ARCH_OVERRIDES``), dropout 0 and ``silu``, on 24 BCC graphs whose
two graph attributes are drawn from a numpy seed, the JAX loader's first
batch of 8. The parameters are the port's draw, jittered and written into
the JAX model's variables (``torch_port_util.PairSetup``), then carried
back by ``convert.load_jax_variables``.

Bounds: the stacks' fp32 bounds of ``test_torch_edge_features.py``
(forward rtol 2e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-6): the
conditioning layers are Dense layers and a gather, summed in another order
by XLA and PyTorch. The GIN's three modes and CGCNN's ``concat_node``
(its width rule) run by default (2-3.5 s each); the other eight cases
(2-5 s each) are ``slow``: ``test_torch_option_train.py`` trains the
EGNN's ``film`` against JAX by default.
"""

import copy

import numpy as np
import pytest

import torch_port_util as tpu
from hydragnn_tpu.datasets import deterministic_graph_data
from test_config import CI_CONFIG
from test_training_e2e import ARCH_OVERRIDES

FWD_TOL = dict(rtol=2e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MODES = ("film", "concat_node", "fuse_pool")
ATTR_WIDTH = 2


def conditioned_config(stack: str, mode: str | None, **training) -> dict:
    cfg = copy.deepcopy(CI_CONFIG)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(mpnn_type=stack, **ARCH_OVERRIDES.get(stack, {}), dropout=0.0,
                activation_function="silu")
    if stack == "EGNN":
        arch["equivariance"] = True
    if mode is not None:
        arch.update(use_graph_attr_conditioning=True, graph_attr_conditioning_mode=mode)
    cfg["NeuralNetwork"]["Training"].update(batch_size=8, **training)
    return cfg


def attributed_samples(n: int = 24, width: int = ATTR_WIDTH, seed: int = 7):
    """BCC graphs with ``width`` graph attributes drawn from a numpy seed."""
    samples = deterministic_graph_data(number_configurations=n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for s in samples:
        s.graph_attr = rng.normal(size=(width,)).astype(np.float32)
    return samples


CASES = [(stack, mode) for stack in ("GIN", "EGNN", "CGCNN", "MACE") for mode in MODES]
DEFAULT = {("CGCNN", "concat_node")}


@pytest.mark.parametrize("stack,mode", [
    pytest.param(stack, mode,
                 marks=() if stack == "GIN" or (stack, mode) in DEFAULT else pytest.mark.slow)
    for stack, mode in CASES], ids=[f"{s}-{m}" for s, m in CASES])
def test_conditioning_matches_jax(stack, mode):
    setup = tpu.PairSetup(conditioned_config(stack, mode), attributed_samples())
    model = setup.port_model()
    names = {"film": "graph_conditioner", "concat_node": "graph_concat_projector",
             "fuse_pool": "graph_pool_projector"}
    assert any(n.startswith(names[mode]) for n, _ in model.named_parameters())
    assert model.spec.graph_attr_dim == ATTR_WIDTH
    setup.assert_matches("fp32", FWD_TOL, GRAD_TOL, f"{stack} {mode}")
    # the attributes act: other attributes, other outputs
    from hydragnn_tpu_torch.convert import batch_from_numpy
    from hydragnn_tpu_torch.train.step import make_predict_step

    b = batch_from_numpy(setup.batch)
    moved = b.replace(graph_attr=b.graph_attr + 1.0)
    step = make_predict_step(model)
    assert not np.allclose(step(b)[0].numpy(), step(moved)[0].numpy())


@pytest.mark.parametrize("mode", MODES)
def test_zero_width_attributes_build_no_conditioner(mode):
    """Without graph attributes the JAX model creates no conditioning
    parameters (flax never calls the conditioner), and neither does the
    port: ``load_jax_variables`` needs the port's entries to be exactly the
    flax tree's."""
    samples = deterministic_graph_data(number_configurations=24, seed=7)
    setup = tpu.PairSetup(conditioned_config("GIN", mode), samples)
    model = setup.port_model()  # every entry covered, every flax leaf placed
    assert setup.spec.graph_attr_dim == 0
    assert not any(n.startswith("graph_") and "shared" not in n and "convs" not in n
                   for n, _ in model.named_parameters())
    plain = tpu.PairSetup(conditioned_config("GIN", None), samples).port_model()
    assert [n for n, _ in model.named_parameters()] == [n for n, _ in plain.named_parameters()]


def test_unknown_conditioning_mode_raises():
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = conditioned_config("GIN", "film")
    cfg["NeuralNetwork"]["Architecture"]["graph_attr_conditioning_mode"] = "gate"
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg),
                                            samples=tpu.port_samples(attributed_samples()))
    aug = update_config(cfg, *(ld.samples for ld in loaders))
    with pytest.raises(ValueError, match="graph_attr_conditioning_mode"):
        create_model_config(aug, device="cpu")


def test_concat_node_widths_flow_into_norms_and_heads():
    """``concat_node`` projects every layer's output to ``hidden_dim``: the
    GAT's concatenated heads (6 x hidden) would need projectors of other
    widths, which the JAX package's one shared projector cannot be either;
    MACE's collected outputs are each ``hidden_dim`` wide."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    def build(stack):
        cfg = conditioned_config(stack, "concat_node")
        loaders = dataset_loading_and_splitting(
            copy.deepcopy(cfg), samples=tpu.port_samples(attributed_samples()))
        return create_model_config(update_config(cfg, *(ld.samples for ld in loaders)),
                                   device="cpu")

    with pytest.raises(ValueError, match="widths differ"):
        build("GAT")
    mace = build("MACE")
    hidden = mace.spec.hidden_dim
    assert tuple(mace.graph_concat_projector.weight.shape) == (hidden, hidden + ATTR_WIDTH)
    head = mace.graph_shared["branch-0"].dense_0
    assert head.weight.shape[1] == hidden * mace.spec.num_conv_layers
