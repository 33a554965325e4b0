"""``chip_smoke.py``'s exact launch counts of the geometric stacks, held here
against what the CPU route calls: on the CPU the wrappers take their plain
versions and count nothing, so each test counts the calls of the
device-routed launchers (``_gather_scatter`` for B1 and its transposed
launch, ``_segment_sum`` for B2, ``_segment_softmax`` and
``_masked_softmax`` for B3 and B4) through ``chip_smoke.cpu_route_calls``:
the launches the card makes on the same step. The card gates the same counts
(``chip_smoke.py`` phases 4, 5 and 8; ``tests/test_torch_capture_gpu.py``).

The qm9 stacks at ``chip_smoke.GEOMETRIC``'s published widths (hidden 32 or
64, 4 conv layers) and ``chip_smoke.EDGE_KINDS`` (edge features, GPS-PNA,
the performer) on 8 QM9-like molecules, a bf16 predict and train step;
the PAINN and MACE MLIPs of ``chip_smoke.mlip_config`` (3 layers) on 4 LJ
cells, a train and an eval step.
"""

import copy

import pytest
import torch

import chip_smoke as cs
import torch_port_util  # noqa: F401  (one torch thread)
from hydragnn_tpu_torch.graphs.batching import collate
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.train.step import create_train_state


@pytest.fixture
def calls():
    """Counts of the launchers' calls by entry point
    (``chip_smoke.cpu_route_calls``), as ``fused_scatter.LAUNCHES`` counts the card's
    launches; ``take()`` returns them and starts again from 0."""
    with cs.cpu_route_calls() as counts:
        def take():
            out = dict(counts)
            for k in counts:
                counts[k] = 0
            return out

        yield take


@pytest.mark.parametrize("kind", sorted(cs.GEOMETRIC) + sorted(cs.EDGE_KINDS))
def test_qm9_stack_launches_are_chip_smokes(kind, calls):
    from hydragnn_tpu_torch.train.step import make_predict_step, make_train_step

    _, aug, loaders, _ = cs.prepare(0, kind, n_samples=40)
    layers = int(aug["NeuralNetwork"]["Architecture"]["num_conv_layers"])
    model = create_model_config(aug, device="cpu")
    batch = collate(loaders[0].samples[:8], loaders[0].pad)
    calls()
    make_predict_step(model, torch.bfloat16)(batch)
    assert calls() == cs.launches_per_forward(kind, layers)
    state = create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"])
    # a fresh batch: the layouts the predict step cached are inference tensors
    make_train_step(torch.bfloat16)(state, collate(loaders[0].samples[:8], loaders[0].pad))
    assert calls() == cs.launches_per_train_step(kind, layers)


@pytest.mark.parametrize("arch", cs.MLIP_ARCHS)
def test_mlip_launches_are_chip_smokes(arch, calls):
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.mlip import make_mlip_eval_step, make_mlip_train_step
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = cs.mlip_config(1, arch)
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=cs.mlip_samples(40))
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
    layers = int(aug["NeuralNetwork"]["Architecture"]["num_conv_layers"])
    assert aug["NeuralNetwork"]["Architecture"]["mpnn_type"] == arch
    model = create_model_config(aug, device="cpu")
    batch = collate(loaders[0].samples[:4], loaders[0].pad)
    state = create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"])
    calls()
    make_mlip_train_step(model)(state, batch)
    assert calls() == cs.mlip_launches_per_step(layers, arch)
    make_mlip_eval_step(model)(state, batch)
    assert calls() == cs.mlip_launches_per_eval(layers, arch)
