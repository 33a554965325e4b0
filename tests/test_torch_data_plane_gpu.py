"""The data plane on the card: a batch collated from a packed store and
moved to the card equals the batch of the same samples held in memory,
field by field; and one captured EGNN MLIP train step (B2 on every segment
sum) from a ``store.loader`` batch is bit-equal to the eager step on a
copy of the same state. The samples are the oc20 block's LJ cells, passed
through ``dataset_loading_and_splitting`` (a store keeps what the model
reads: inputs selected, targets columnar) and written with
``PackedWriter``; the model is that block's EGNN at a small width.

Every test is ``gpu``-marked and skips without a CUDA device (the card's
machine has no JAX, so skip the conftest):

    python -m pytest tests/test_torch_data_plane_gpu.py -m gpu --noconftest -q
"""

import copy

import pytest
import torch

import chip_smoke as cs
from hydragnn_tpu_torch import capture
from hydragnn_tpu_torch.datasets import lennard_jones_data
from hydragnn_tpu_torch.datasets.packed import GlobalShuffleStore, PackedWriter
from hydragnn_tpu_torch.graphs.batching import GraphLoader
from hydragnn_tpu_torch.graphs.graph import FIELDS

pytestmark = pytest.mark.gpu


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _config():
    """``examples/oc20/train.py``'s block at hidden 16 x 2, batch 4. Its
    inputs are not normalised, so the atomic numbers collate reads equal the
    input column a store keeps (a store keeps no ``atomic_numbers`` extra,
    in either package)."""
    cfg = cs.oc20_block_config(1)
    cfg["NeuralNetwork"]["Architecture"].update(hidden_dim=16, num_conv_layers=2)
    cfg["NeuralNetwork"]["Training"]["batch_size"] = 4
    return cfg


@pytest.fixture(scope="module")
def store_setup(tmp_path_factory):
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = _config()
    samples = lennard_jones_data(number_configurations=24, cells_per_dim=2, seed=7,
                                 relative_maximum_atomic_displacement=0.05)
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=samples)
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
    path = str(tmp_path_factory.mktemp("store") / "train.gpk")
    PackedWriter(loaders[0].samples, path)
    return aug, loaders[0].samples, GlobalShuffleStore(path)


def _first_batches(store_setup):
    _, samples, store = store_setup
    from_store = store.loader(4, seed=3)
    in_memory = GraphLoader(samples, 4, pad=from_store.pad, shuffle=True, seed=3)
    return next(iter(from_store)), next(iter(in_memory))


def test_store_batch_on_the_card_equals_the_in_memory_batch(store_setup):
    _cuda_or_skip()
    a, b = (x.to("cuda") for x in _first_batches(store_setup))
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_captured_mlip_step_from_a_store_batch_equals_the_eager_step(store_setup):
    _cuda_or_skip()
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.models.mlip import make_mlip_train_step
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.train.step import create_train_state

    aug = store_setup[0]
    host, _ = _first_batches(store_setup)
    model = create_model_config(aug, device="cuda", seed=0)
    state = create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"], seed=0)
    step = make_mlip_train_step(model, torch.float32)
    captured, eager = cs._twin(torch, state), cs._twin(torch, state)
    train = capture.Dispatch(step, "train", train=True)
    for _ in range(2):  # the capture, then a replay
        fs.reset_launches()
        got = train(captured, host.to("cuda"))
        want = step(eager, host.to("cuda"))
        assert cs._same_tree(torch, got, want)
        assert cs._state_diffs(torch, captured, eager) == []
    want_launches = cs.oc20_launches(2)[0]
    (graph,) = train.graphs.graphs.values()
    assert graph.launches == want_launches
    assert fs.LAUNCHES["segment_sum"] == 2 * want_launches["segment_sum"]
