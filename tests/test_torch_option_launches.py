"""``chip_smoke.py``'s exact launch counts and Dense-call counts of this
slice's kinds, held here against what the CPU route calls
(``chip_smoke.cpu_route_calls``; see ``test_torch_geometric_launches.py``):
the qm9.json GIN with GaussianNLLLoss, the GAT with ``conv_checkpointing``
(each conv's forward launches again in the backward's recompute), the
two-branch GIN of ``examples/multidataset/train.py`` and the MPTrj EGNN
MLIP with film conditioning (its gathers of the per-graph scale and shift
add one segment sum a layer to the train step's backward). The card gates
the same counts (``chip_smoke.py``'s option phases).
"""

import copy

import pytest
import torch

import chip_smoke as cs
import torch_port_util  # noqa: F401  (one torch thread)
from hydragnn_tpu_torch.graphs.batching import collate
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.models.common import intercept_dense
from hydragnn_tpu_torch.train.step import (create_train_state, make_predict_step,
                                           make_train_step)


@pytest.fixture
def calls():
    with cs.cpu_route_calls() as counts:
        def take():
            out = dict(counts)
            for k in counts:
                counts[k] = 0
            return out

        yield take


def _setup(kind: str, n: int = 40):
    _, aug, loaders, _ = cs.prepare(0, kind, n_samples=n)
    model = create_model_config(aug, device="cpu")
    layers = int(aug["NeuralNetwork"]["Architecture"]["num_conv_layers"])
    return aug, loaders, model, layers


@pytest.mark.parametrize("kind", ["gin_nll", "gat_ckpt", "gfm_branches"])
def test_option_kind_launches_are_chip_smokes(kind, calls):
    aug, loaders, model, layers = _setup(kind)
    batch = collate(loaders[0].samples[:8], loaders[0].pad)
    calls()
    make_predict_step(model, torch.bfloat16)(batch)
    assert calls() == cs.launches_per_forward(kind, layers)
    state = create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"])
    make_train_step(torch.bfloat16)(state, collate(loaders[0].samples[:8], loaders[0].pad))
    assert calls() == cs.launches_per_train_step(kind, layers)
    if kind == "gat_ckpt":
        # the recompute: each layer's softmax and aggregation once more
        plain = cs.launches_per_train_step("gat", layers)
        assert cs.launches_per_train_step(kind, layers)["segment_softmax"] == \
            plain["segment_softmax"] + layers


def test_mptrj_film_mlip_launches_are_chip_smokes(calls):
    from hydragnn_tpu_torch.models.mlip import make_mlip_eval_step, make_mlip_train_step

    aug, loaders, model, layers = _setup("mptrj_film")
    assert model.conditioning == "film" and model.spec.graph_attr_dim == 2
    batch = collate(loaders[0].samples[:4], loaders[0].pad)
    state = create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"])
    calls()
    make_mlip_train_step(model)(state, batch)
    assert calls() == cs.mlip_launches_per_step(layers, "EGNN", "mptrj_film")
    make_mlip_eval_step(model)(state, batch)
    assert calls() == cs.mlip_launches_per_eval(layers, "EGNN", "mptrj_film")
    make_predict_step(model)(batch)
    assert calls() == cs.launches_per_forward("mptrj_film", layers)


@pytest.mark.parametrize("kind", ["gin_nll", "gat_ckpt", "gfm_branches", "mptrj_film"])
def test_option_kind_dense_calls_are_chip_smokes(kind):
    """``QUANT_DENSE_CALLS``: one B6 launch per Dense call of the served
    forward on an int8 endpoint; ``mlp_per_node`` banks and the GIN's
    ``eps`` are no Dense."""
    aug, loaders, model, _ = _setup(kind)
    seen = []
    with intercept_dense(lambda m, x: seen.append(m)):
        make_predict_step(model)(collate(loaders[0].samples[:4], loaders[0].pad))
    assert len(seen) == cs.QUANT_DENSE_CALLS[kind]


def test_option_kinds_data():
    """The two blocks on their own data: both branches present and tagged,
    the MPTrj crystals' labels and spread attributes; the per-node canary
    on graphs of one size."""
    import numpy as np

    from hydragnn_tpu_torch.datasets import deterministic_graph_data

    gfm = cs.raw_samples(0, "gfm_branches")
    ids = np.bincount([s.dataset_id for s in gfm])
    assert ids.tolist() == [cs.GFM_CONFIGS, cs.GFM_CONFIGS // 2]
    film = cs.raw_samples(0, "mptrj_film")
    assert len(film) == cs.MPTRJ_CONFIGS
    assert set(np.unique(np.concatenate([s.x[:, 0] for s in film]))) <= {8.0, 13.0, 14.0, 26.0}
    attrs = np.stack([s.graph_attr for s in film])
    assert len({tuple(a) for a in attrs}) > 1 and attrs.shape[1] == 2
    cfg = cs.canary_config("gin_per_node")
    assert cfg["NeuralNetwork"]["Architecture"]["output_heads"]["node"]["type"] == "mlp_per_node"
    sizes = {s.num_nodes for s in deterministic_graph_data(
        40, seed=7, **cs.CANARY_DATA["gin_per_node"])}
    assert len(sizes) == 1
    assert copy.deepcopy(cs.VARIANT_VOI["node_branches"])["output_dim"] == [3]


def test_int8_calibrates_the_new_dense_layers_not_the_banks():
    """int8 serving quantizes every Dense the forward calls: the film
    conditioner's, the conv heads' layers; the ``mlp_per_node`` weight
    banks are no Dense and stay fp32 (flax's interceptor sees no
    ``nn.Dense`` there either)."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.datasets import deterministic_graph_data
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
    from hydragnn_tpu_torch.serve import quant as sq

    aug, loaders, model, _ = _setup("mptrj_film")
    scales = sq.collect_activation_scales(
        model, [collate(loaders[0].samples[:4], loaders[0].pad)])
    assert {"graph_conditioner.dense_0", "graph_conditioner.dense_1"} <= set(scales)
    for node_type, data in (("mlp_per_node", cs.CANARY_DATA["gin_per_node"]), ("conv", {})):
        cfg = cs.canary_config("gin_per_node" if node_type == "mlp_per_node"
                               else "gin_conv_heads", epochs=1)
        lds = dataset_loading_and_splitting(
            copy.deepcopy(cfg), samples=deterministic_graph_data(24, seed=7, **data))
        a = update_config(copy.deepcopy(cfg), *(ld.samples for ld in lds))
        m = create_model_config(a, device="cpu")
        names = set(sq.collect_activation_scales(m, [collate(lds[0].samples[:4], lds[0].pad)]))
        heads = {n for n in names if n.startswith("heads_NN.1.")}
        if node_type == "conv":
            assert any(".conv0." in n for n in heads) and any(".convout." in n for n in heads)
        else:
            assert not heads
            table = sq.quantize_dense_weights(m, dict.fromkeys(names, 1.0))
            assert set(table) == names
