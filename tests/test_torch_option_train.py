"""Training with this slice's options against the JAX package on the CPU:
the MPTrj block's EGNN MLIP with ``film`` conditioning on (charge, spin)
graph attributes (``examples/mptrj/train.py``, at hidden 8 and 2 conv
layers), and the multidataset block's two-branch GIN
(``examples/multidataset/train.py``, hidden 8, 2 conv layers) on two BCC
datasets tagged by ``concat_multidataset``.

* One MLIP train step from the same parameters: each parameter's gradient
  (a gradient of the force gradient) within 1e-4 of that tensor's largest
  JAX gradient, as ``test_torch_mlip.py`` holds the plain EGNN's.
* Three epochs through the port's epoch loop (``train_validate_test``, what
  ``run_training`` runs) from the JAX model's converted parameters, against
  the JAX package's ``train_epoch``/``evaluate`` on the same splits and
  batch order: train, validation and test losses within rtol 1e-4
  (``test_torch_train_loop.py``'s bound under SGD), under SGD for both
  models and under the blocks' own AdamW for the MLIP. The GIN under AdamW
  is left out: a bias in front of a batch norm has a gradient of fp32 noise,
  which AdamW follows by up to the learning rate per step, differently in
  the two packages, and eval mode does not cancel the shift
  (``test_torch_train_loop.py``'s 6e-2; here its validation losses read
  up to 0.13 apart, its train losses 9e-5, while under SGD all nine agree
  to 7e-7); the EGNN has no batch norm, and its AdamW losses agree to 2e-7.
* ``run_training`` itself for 3 epochs: the loss falls, ``run_prediction``
  answers.

``slow``: the MLIP step's gradients (~20 s, the jitted JAX gradient of a
gradient; the AdamW trajectory, which runs by default, steps the same
model) and the MLIP's SGD trajectory (its AdamW one runs by default).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_util as tpu
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.datasets.lennard_jones import lennard_jones_data
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models import mlip as jmlip
from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jax_loading
from hydragnn_tpu.train.loop import evaluate as jax_evaluate
from hydragnn_tpu.train.loop import train_epoch as jax_train_epoch
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.step import create_train_state as jax_create_train_state
from hydragnn_tpu.train.step import make_eval_step as jax_make_eval_step
from hydragnn_tpu.train.step import make_train_step as jax_make_train_step
from test_config import CI_CONFIG

EPOCHS = 3
REL = 1e-4


def film_mlip_config() -> dict:
    """``examples/mptrj/train.py``'s block (EGNN, energy per atom 1, force
    25, silu, add pooling, AdamW 5e-3, film) at hidden 8 and 2 layers."""
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"name": "mptrj_small", "format": "unit_test",
                    "node_features": {"name": ["atomic_number"], "dim": [1],
                                      "column_index": [0]},
                    "graph_features": {"name": ["energy"], "dim": [1], "column_index": [0]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "EGNN", "radius": 5.0, "max_neighbours": 100, "hidden_dim": 8,
                "num_conv_layers": 2, "equivariance": True,
                "enable_interatomic_potential": True, "activation_function": "silu",
                "energy_weight": 0.0, "energy_peratom_weight": 1.0, "force_weight": 25.0,
                "graph_pooling": "add", "use_graph_attr_conditioning": True,
                "graph_attr_conditioning_mode": "film",
                "output_heads": {"node": {"num_headlayers": 2, "dim_headlayers": [8, 8],
                                          "type": "mlp"}},
                "task_weights": [1.0],
            },
            "Variables_of_interest": {"input_node_features": [0], "output_index": [0],
                                      "type": ["node"], "output_dim": [1],
                                      "denormalize_output": False},
            "Training": {"num_epoch": EPOCHS, "batch_size": 4, "perc_train": 0.7,
                         "loss_function_type": "mse",
                         "Optimizer": {"type": "AdamW", "learning_rate": 0.005}},
        },
    }


def film_samples(n: int = 24, seed: int = 3):
    """LJ cells with (charge, spin) graph attributes spread over the
    structures (MPTrj's are all (0, 1): a spread gives film something to
    act on)."""
    samples = lennard_jones_data(number_configurations=n, cells_per_dim=2, seed=seed)
    rng = np.random.default_rng(seed)
    for s in samples:
        s.graph_attr = np.array([rng.integers(-1, 2), rng.integers(1, 3)], np.float32)
    return samples


def branch_config() -> dict:
    """``examples/multidataset/train.py``'s block (GIN, two graph branches
    of 1 x 16 shared and 2 x 32 head layers, AdamW 5e-3) at hidden 8 and 2
    layers."""
    cfg = copy.deepcopy(CI_CONFIG)
    arch = {"num_sharedlayers": 1, "dim_sharedlayers": 16, "num_headlayers": 2,
            "dim_headlayers": [32, 32]}
    cfg["NeuralNetwork"]["Architecture"]["output_heads"] = {
        "graph": [{"type": f"branch-{i}", "architecture": dict(arch)} for i in range(2)]}
    cfg["NeuralNetwork"]["Training"].update(num_epoch=EPOCHS, batch_size=8,
                                            Optimizer={"type": "AdamW", "learning_rate": 0.005})
    return cfg


def branch_samples():
    """Two BCC datasets (seeds 100 and 101, the second half the size, its
    targets doubled: ``make_synthetic``'s branch scaling), tagged."""
    from hydragnn_tpu.train.multibranch import concat_multidataset

    sets = []
    for b, n in enumerate((32, 16)):
        ds = deterministic_graph_data(number_configurations=n, seed=100 + b)
        for s in ds:
            s.graph_y = (1.0 + b) * s.graph_y
        sets.append(ds)
    return concat_multidataset(sets)


CASES = {"film_mlip": (film_mlip_config, film_samples, True),
         "two_branch_gin": (branch_config, branch_samples, False)}


def _jax_setup(cfg, samples):
    jl = jax_loading(copy.deepcopy(cfg), samples=tpu.jax_samples_copy(samples))
    jaug = jax_update_config(copy.deepcopy(cfg), *(ld.samples for ld in jl))
    jmodel = jax_create_model_config(jaug)
    opt = jax_select_optimizer(jaug["NeuralNetwork"]["Training"]["Optimizer"])
    jstate = jax_create_train_state(jmodel, opt, next(iter(jl[0])))
    variables = tpu.jitter_params({"params": jstate.params}, seed=1, scale=0.1)
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, variables["params"]))
    return jl, jaug, jmodel, opt, jstate


def _port_setup(cfg, samples, jstate):
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    pl = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=tpu.port_samples(samples))
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in pl))
    model = tpu.port_model_from_jax(aug, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})
    return pl, aug, model


@pytest.mark.slow
def test_film_mlip_step_gradients_match_jax():
    from hydragnn_tpu_torch.convert import batch_from_numpy, port_arrays
    from hydragnn_tpu_torch.models import mlip
    from hydragnn_tpu_torch.train.step import create_train_state

    cfg, samples = film_mlip_config(), film_samples()
    jl, jaug, jmodel, _, jstate = _jax_setup(cfg, samples)
    _, aug, model = _port_setup(cfg, samples, jstate)
    assert model.spec.graph_attr_dim == 2 and model.conditioning == "film"
    nb = next(iter(jl[0]))
    jb = jax.tree.map(jnp.asarray, nb)
    spec, efn = jmodel.spec, jmlip.make_graph_energy_fn(jmodel)

    def loss(params):
        def total(pos):
            e = efn({"params": params}, pos, jb, True)
            return e.sum(), e

        (_, ge), gp = jax.value_and_grad(total, has_aux=True)(jb.pos)
        return jmlip.energy_force_loss(spec, ge, -gp * jb.node_mask[:, None], jb)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jstate.params)
    state = create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"])
    metrics = mlip.make_mlip_train_step(model)(state, batch_from_numpy(nb))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-4)
    want = port_arrays(jax.tree.map(np.asarray, jgrads))
    assert any(k.startswith("graph_conditioner") for k in want)
    for name, p in model.named_parameters():
        scale = max(float(np.abs(want[name]).max()), 1e-6)
        err = float(np.abs(p.grad.numpy() - want[name]).max())
        assert err <= REL * scale, f"{name}: max|grad diff| {err:.3e} > {REL} x {scale:.3e}"


@pytest.mark.parametrize("case,opt_type", [
    ("film_mlip", "AdamW"), pytest.param("film_mlip", "SGD", marks=pytest.mark.slow),
    ("two_branch_gin", "SGD")])
def test_three_epoch_trajectory_matches_jax(case, opt_type):
    from hydragnn_tpu_torch.train.loop import train_validate_test
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.step import TrainState

    make_cfg, make_samples, is_mlip = CASES[case]
    cfg, samples = make_cfg(), make_samples()
    cfg["NeuralNetwork"]["Training"]["Optimizer"]["type"] = opt_type
    jl, jaug, jmodel, opt, jstate = _jax_setup(cfg, samples)
    pl, aug, model = _port_setup(cfg, samples, jstate)
    if is_mlip:
        jstep = jmlip.make_mlip_train_step(jmodel, opt)
        jeval = jmlip.make_mlip_eval_step(jmodel)
    else:
        jstep, jeval = jax_make_train_step(jmodel, opt), jax_make_eval_step(jmodel)
    want = []
    for epoch in range(EPOCHS):
        jl[0].set_epoch(epoch)
        pl[0].set_epoch(epoch)
        for (jc, _), (pc, _) in zip(jl[0].batch_plan(), pl[0].batch_plan(), strict=True):
            np.testing.assert_array_equal(jc, pc)
        jstate, train_loss, _ = jax_train_epoch(jstep, jstate, jl[0])
        want.append((train_loss, jax_evaluate(jeval, jstate, jl[1])[0],
                     jax_evaluate(jeval, jstate, jl[2])[0]))
    state = TrainState(model, select_optimizer(aug["NeuralNetwork"]["Training"]["Optimizer"],
                                               model.parameters()))
    history = []
    train_validate_test(state, *pl, aug["NeuralNetwork"], case, history=history)
    got = np.array([(h["train_loss"], h["val_loss"], h["test_loss"]) for h in history])
    np.testing.assert_allclose(got, np.array(want), rtol=1e-4)
    assert got[-1][0] < got[0][0], "the train loss falls"


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_training_then_run_prediction(case, tmp_path):
    from hydragnn_tpu_torch import run_prediction, run_training

    make_cfg, make_samples, _ = CASES[case]
    history = []
    state, model, aug = run_training(make_cfg(), samples=tpu.port_samples(make_samples()),
                                     device="cpu", path=str(tmp_path), history=history)
    losses = [h["train_loss"] for h in history]
    assert len(losses) == EPOCHS and losses[-1] < losses[0], losses
    error, _, trues, preds = run_prediction(make_cfg(), state,
                                            samples=tpu.port_samples(make_samples()),
                                            device="cpu")
    assert np.isfinite(error) and all(np.isfinite(p).all() for p in preds)
    assert [p.shape for p in preds] == [t.shape for t in trues]
