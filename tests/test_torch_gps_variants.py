"""GPS around every conv, with relative-PE edge encodings, in the port
against the JAX package on the CPU.

* GPS (multihead) around each of the twelve convs other than the GIN:
  the train-mode forward and every parameter gradient (fp32; one JAX
  compile each, the eval-mode norms being the stacks' own, held in
  ``tests/test_torch_edge_features.py``); ``rel_pos_emb`` (with
  ``edge_emb``/``edge_lin`` where the model has edge features: GPS-PNA,
  GPS-GAT, GPS-SchNet) exactly where flax creates it; the stack's flags
  (feature norms, collected layer outputs) those of the architecture's own
  conv class; CGCNN at ``hidden_dim`` under GPS.

GPS performer attention and one AdamW step of ``chip_smoke.py``'s three
full-width kinds are in ``tests/test_torch_gps_performer.py`` (two files,
so that the test workers share them). Configurations, parameters and tolerances as in
``tests/test_torch_edge_features.py`` (fp32 only for the GPS wrappers:
their bf16 paths are the stacks' own, held there).
"""

import numpy as np
import pytest

from hydragnn_tpu_torch.config.schema import EDGE_MODELS
from test_torch_edge_features import Setup, check_forward, check_gradients, stack_config

LOCAL_CONVS = ("SAGE", "MFC", "SchNet", "PNA", "PNAPlus", "CGCNN", "EGNN", "PAINN", "PNAEq",
               "DimeNet", "MACE", "GAT")
# the GPS wrappers built with edge features too (edge_emb, edge_lin)
WITH_EDGES = {"PNA", "GAT", "SchNet"}


@pytest.fixture(scope="module", params=LOCAL_CONVS)
def variant(request):
    conv = request.param
    return Setup(stack_config(conv, edge=conv in WITH_EDGES, gps="multihead"),
                 eval_outputs=False)


def test_gps_forward_matches_jax(variant):
    check_forward(variant, "fp32", variant.spec.mpnn_type)


def test_gps_gradients_match_jax(variant):
    check_gradients(variant, "fp32", variant.spec.mpnn_type)


def test_rel_pos_emb_where_flax_creates_it(variant):
    """Every layer's ``rel_pos_emb`` (and ``edge_emb``/``edge_lin``) exists
    in the port exactly where it exists among the flax variables, and its
    gradient flows (but into MACE, which reads no edge features: there it
    is 0, as in the JAX package)."""
    conv = variant.spec.mpnn_type
    model = variant.port_model()
    grads = variant.port("fp32")["grads"]
    for i, layer in enumerate(model.graph_convs):
        flax_layer = variant.variables["params"][f"graph_convs_{i}"]
        for name in ("rel_pos_emb", "edge_emb", "edge_lin"):
            want = name in flax_layer
            assert (getattr(layer, name) is not None) == want, (conv, i, name)
            if want:
                flows = np.abs(grads[f"graph_convs.{i}.{name}.weight"]).max() > 0
                assert flows == (conv != "MACE"), (conv, i, name)
        assert ("rel_pos_emb" in flax_layer) == (conv in EDGE_MODELS)
        assert ("edge_lin" in flax_layer) == (conv in WITH_EDGES)


def test_stack_flags_follow_the_architecture(variant):
    """Under GPS the feature norms, the activation and the collected layer
    outputs follow the architecture's own conv class, as in the JAX
    package (``tests/test_gps.py::test_gps_preserves_inner_stack_norm_flags``):
    SchNet, EGNN and the geometric stacks have no feature norms, MACE reads
    every layer's output concatenated."""
    from hydragnn_tpu_torch.models.base import CONV_REGISTRY

    conv = variant.spec.mpnn_type
    model = variant.port_model()
    flax_norms = any(k.startswith("feature_norm") for k in variant.variables["params"])
    assert (len(model.feature_layers) > 0) == flax_norms
    assert flax_norms == getattr(CONV_REGISTRY[conv], "feature_norm", True)
    assert model.collect_layer_outputs == (conv == "MACE")
    assert model.stack_activation == (conv != "MACE")


def test_cgcnn_keeps_hidden_width_under_gps():
    """GPS embeds the input to ``hidden_dim``; CGCNN's residual update then
    keeps that width: no ``local_proj``, ``norm1`` at ``hidden_dim``, and
    the port's shapes are flax's."""
    s = Setup(stack_config("CGCNN", edge=False, gps="multihead"), n_samples=16)
    model = s.port_model()
    hidden = s.spec.hidden_dim
    assert s.spec.input_dim == 1 and hidden == 8
    for i, layer in enumerate(model.graph_convs):
        flax_layer = s.variables["params"][f"graph_convs_{i}"]
        assert layer.local_proj is None and "local_proj" not in flax_layer
        assert layer.norm1.scale.shape == (hidden,) == flax_layer["norm1"]["scale"].shape
        assert layer.local.lin_f.weight.shape == (hidden, 2 * hidden + hidden)
