"""The port's epoch loop, data pieces, checkpoints and ``run_training`` on
the CPU: the same batch order and epoch losses as the JAX package's loop
from the same converted parameters, the deterministic BCC dataset equal to
the JAX package's, the prefetching loader, an exact checkpoint round trip,
and ``run_training`` -> ``run_prediction`` end to end (the full 100-epoch
convergence canaries are ``slow``).

Tolerances of the 3-epoch trajectory: the train losses agree to rtol 1e-4
(the largest difference seen is about 3e-6 relative). The validation and
test losses agree to rtol 1e-4 under SGD but only to rtol 6e-2 under AdamW
(the largest difference seen is 3.1e-2), for a reason of the model, not of
the port: a dense bias that feeds a train-mode batch norm, directly or
through a ReLU that stays open over the batch, has a gradient that is zero
in exact arithmetic (the norm subtracts the batch mean), so in fp32 it is
noise of about 1e-9. Adam moves such a parameter by up to ``lr`` in the
direction of that noise, differently on the two sides; train mode cancels
the shift, while eval mode, normalising with the running mean, does not.
SGD moves it by ``lr * 1e-9``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.datasets import deterministic_graph_data as jax_bcc
from hydragnn_tpu.graphs.batching import GraphLoader as JaxLoader
from hydragnn_tpu.train.loop import evaluate as jax_evaluate
from hydragnn_tpu.train.loop import train_epoch as jax_train_epoch
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.step import make_eval_step as jax_make_eval_step
from hydragnn_tpu.train.step import make_train_step as jax_make_train_step
from hydragnn_tpu_torch.datasets import deterministic_graph_data
from hydragnn_tpu_torch.graphs.batching import GraphLoader, PrefetchLoader
from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
from hydragnn_tpu_torch.train.checkpoint import (
    CheckpointCorruptError,
    load_checkpoint,
    save_checkpoint,
)
from hydragnn_tpu_torch.train.loop import train_validate_test
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.step import TrainState
from test_torch_train_step import Setup, four_head_config, single_head_config

EPOCHS = 3
EVAL_RTOL = {"AdamW": 6e-2, "SGD": 1e-4}


def test_deterministic_graph_data_equals_jax():
    ours = deterministic_graph_data(number_configurations=12, seed=7)
    theirs = jax_bcc(number_configurations=12, seed=7)
    for a, b in zip(ours, theirs):
        for field in ("x", "pos", "senders", "receivers", "edge_shifts"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        for key in ("node_table", "graph_table"):
            np.testing.assert_array_equal(a.extras[key], b.extras[key], err_msg=key)


def test_training_loader_reshuffles_like_jax():
    """The train loader's batch order per epoch is the JAX loader's
    (``default_rng(seed + epoch)``)."""
    samples = deterministic_graph_data(number_configurations=40, seed=1)
    ours = GraphLoader(samples, 8, shuffle=True, seed=5)
    theirs = JaxLoader(samples, 8, shuffle=True, seed=5)
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = [c.tolist() for c, _ in ours.batch_plan()]
        assert got == [c.tolist() for c, _ in theirs.batch_plan()]
    ours.set_epoch(0)
    first = [c.tolist() for c, _ in ours.batch_plan()]
    ours.set_epoch(1)
    assert first != [c.tolist() for c, _ in ours.batch_plan()]


def test_prefetch_loader_yields_the_loader_batches_and_reraises():
    samples = deterministic_graph_data(number_configurations=24, seed=2)
    loader = GraphLoader(samples, 4, shuffle=True, seed=3)
    loader.set_epoch(2)
    pf = PrefetchLoader(loader, depth=2, device=torch.device("cpu"))
    assert len(pf) == len(loader) and pf.samples is loader.samples and pf.seed == 3
    for a, b in zip(pf, loader, strict=True):
        assert torch.equal(a.x, b.x) and torch.equal(a.senders, b.senders)
    it = iter(pf)
    next(it)
    it.close()  # an abandoned iteration stops its worker

    class Broken:
        samples, pad, seed = [], None, 0

        def __iter__(self):
            yield from ()
            raise RuntimeError("collate failed")

    with pytest.raises(RuntimeError, match="collate failed"):
        list(PrefetchLoader(Broken()))


@pytest.fixture(scope="module", params=["single_head", "four_heads"])
def loop_setup(request):
    cfg = {"single_head": single_head_config, "four_heads": four_head_config}[request.param]()
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = EPOCHS
    return Setup(cfg, n_samples=64)


def _port_loaders(setup):
    return dataset_loading_and_splitting(copy.deepcopy(setup.cfg),
                                         samples=tpu.port_samples(_raw_samples()))


def _raw_samples():
    return jax_bcc(number_configurations=64, seed=7)


@pytest.mark.parametrize("opt_type", ["AdamW", "SGD"])
def test_three_epoch_trajectory_matches_jax(loop_setup, opt_type):
    """Three epochs from the same parameters: the same batches in the same
    order, and epoch train/val/test losses allclose."""
    from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jax_loading

    setup = loop_setup
    opt_cfg = {**setup.opt_cfg, "type": opt_type}
    jl = jax_loading(copy.deepcopy(setup.cfg), samples=_raw_samples())
    pl = _port_loaders(setup)
    jstep = (setup.jstep if opt_type == "AdamW"
             else jax_make_train_step(setup.jmodel, jax_select_optimizer(opt_cfg)))
    jeval = jax_make_eval_step(setup.jmodel)
    jstate = setup.jstate._replace(opt_state=jax_select_optimizer(opt_cfg).init(
        setup.jstate.params))
    want = []
    for epoch in range(EPOCHS):
        jl[0].set_epoch(epoch)
        pl[0].set_epoch(epoch)
        for (jc, _), (pc, _) in zip(jl[0].batch_plan(), pl[0].batch_plan(), strict=True):
            np.testing.assert_array_equal(jc, pc)
        jstate, train_loss, _ = jax_train_epoch(jstep, jstate, jl[0])
        val_loss, _, _ = jax_evaluate(jeval, jstate, jl[1])
        test_loss, _, _ = jax_evaluate(jeval, jstate, jl[2])
        want.append((train_loss, val_loss, test_loss))

    port = setup.port_model()
    state = TrainState(port, select_optimizer(opt_cfg, port.parameters()))
    history = []
    train_validate_test(state, *pl, setup.aug["NeuralNetwork"], "trajectory", history=history)
    got = np.array([(h["train_loss"], h["val_loss"], h["test_loss"]) for h in history])
    want = np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=EVAL_RTOL[opt_type])
    assert state.step == EPOCHS * len(pl[0])
    assert got[-1][0] < got[0][0], "the train loss falls"


def _fresh_state(setup):
    port = setup.port_model()
    return TrainState(port, select_optimizer(setup.opt_cfg, port.parameters()))


def test_checkpoint_round_trip_resumes_exactly(loop_setup, tmp_path):
    """Two epochs, a checkpoint, a fresh model and optimizer restored from
    it, and the third epoch: bit-identical to three uninterrupted epochs."""
    setup = loop_setup
    nn_cfg = setup.aug["NeuralNetwork"]
    whole = _fresh_state(setup)
    train_validate_test(whole, *_port_loaders(setup), nn_cfg, "whole")

    first = _fresh_state(setup)
    two = copy.deepcopy(nn_cfg)
    two["Training"]["num_epoch"] = EPOCHS - 1
    train_validate_test(first, *_port_loaders(setup), two, "resumed")
    save_checkpoint(first, "resumed", EPOCHS - 2, path=str(tmp_path), meta={"note": "x"})

    resumed = _fresh_state(setup)
    meta = load_checkpoint(resumed, "resumed", path=str(tmp_path))
    assert meta == {"epoch": EPOCHS - 2, "note": "x"} and resumed.step == first.step
    train_validate_test(resumed, *_port_loaders(setup), nn_cfg, "resumed",
                        start_epoch=EPOCHS - 1)
    for (name, a), b in zip(whole.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert resumed.step == whole.step


def test_checkpoint_detects_a_torn_write_and_falls_back(tmp_path):
    setup = Setup(single_head_config(), n_samples=24)
    state = _fresh_state(setup)
    save_checkpoint(state, "run", 0, path=str(tmp_path))
    with torch.no_grad():
        state.model.graph_convs[0].eps.add_(1.0)
    path = save_checkpoint(state, "run", 1, path=str(tmp_path))
    payload = torch.load(path, weights_only=True)
    payload["model"]["graph_convs.0.eps"] += 1.0  # the payload no longer matches
    torch.save(payload, path)

    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(_fresh_state(setup), "run", path=str(tmp_path), epoch=1)
    restored = _fresh_state(setup)
    with pytest.warns(UserWarning, match="fallback"):
        meta = load_checkpoint(restored, "run", path=str(tmp_path))
    assert meta["epoch"] == 0
    assert torch.equal(restored.model.graph_convs[0].eps, setup.port_model().graph_convs[0].eps)
    with pytest.raises(FileNotFoundError, match="no loadable checkpoint"):
        load_checkpoint(_fresh_state(setup), "other", path=str(tmp_path))


# -- run_training / run_prediction ---------------------------------------------


def _small_run_config():
    cfg = single_head_config()
    cfg["NeuralNetwork"]["Training"].update(num_epoch=4, Checkpoint=True, EarlyStopping=True,
                                            patience=10)
    return cfg


def test_run_training_then_run_prediction_and_reload(tmp_path):
    """``run_training`` on the CPU: it trains, writes the best and final
    checkpoints, and a fresh model restored from the final one gives the
    trained model's ``run_prediction`` exactly."""
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.models import create_model_config

    cfg = _small_run_config()
    samples = deterministic_graph_data(number_configurations=64, seed=7)
    state, model, aug = run_training(copy.deepcopy(cfg), samples=samples, device="cpu",
                                     path=str(tmp_path))
    assert state.model is model and state.step == 4 * 2
    error, tasks, trues, preds = run_prediction(copy.deepcopy(cfg), state, samples=samples,
                                                device="cpu")
    assert np.isfinite(error) and preds[0].shape == trues[0].shape

    fresh = create_model_config(aug, device="cpu", seed=123)
    from hydragnn_tpu_torch.config import get_log_name_config

    meta = load_checkpoint(_plain_state(fresh, aug), get_log_name_config(aug), path=str(tmp_path))
    assert meta["final"] is True
    again = run_prediction(copy.deepcopy(cfg), fresh, samples=samples, device="cpu")
    assert again[0] == error
    np.testing.assert_array_equal(again[3][0], preds[0])


def _plain_state(model, aug):
    return TrainState(model, select_optimizer(aug["NeuralNetwork"]["Training"]["Optimizer"],
                                              model.parameters()))


@pytest.mark.parametrize("section,key,value,what", [
    ("Training", "steps_per_dispatch", 2, "supersteps"),
    ("Training", "population", {"size": 2}, "population"),
    ("Training", "resilience", {"nonfinite_guard": True}, "resilience"),
    ("Architecture", "edge_sharding", True, "edge sharding"),
    ("Architecture", "parallelism", "pipeline", "mesh"),
])
def test_run_training_refuses_later_slices(section, key, value, what):
    from hydragnn_tpu_torch import run_training

    cfg = _small_run_config()
    cfg["NeuralNetwork"][section][key] = value
    with pytest.raises(NotImplementedError, match=what):
        run_training(cfg, samples=[], device="cpu")


def test_run_training_defaults_to_the_card():
    from hydragnn_tpu_torch import run_training

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(_small_run_config(), samples=[])


@pytest.mark.slow
@pytest.mark.parametrize("config", ["single_head", "four_heads"])
def test_gin_canaries_converge_on_cpu(config, tmp_path):
    """The tier-1 GIN canaries (``tests/test_training_e2e.py``) through the
    port's ``run_training`` and ``run_prediction``: 500 BCC samples,
    100 epochs, head RMSE < 0.25 and sample MAE < 0.20."""
    from hydragnn_tpu_torch import run_prediction, run_training

    cfg = {"single_head": single_head_config, "four_heads": four_head_config}[config]()
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 100
    if config == "single_head":
        cfg["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"] = 0.02
    samples = deterministic_graph_data(number_configurations=500, seed=7)
    state, _, _ = run_training(copy.deepcopy(cfg), samples=samples, device="cpu",
                               path=str(tmp_path))
    _, _, trues, preds = run_prediction(copy.deepcopy(cfg), state, samples=samples, device="cpu")
    for ihead, (t, p) in enumerate(zip(trues, preds)):
        rmse = float(np.sqrt(np.mean((t - p) ** 2)))
        mae = float(np.mean(np.abs(t - p)))
        assert rmse < 0.25, f"head {ihead} RMSE {rmse:.3f}"
        assert mae < 0.20, f"head {ihead} MAE {mae:.3f}"
