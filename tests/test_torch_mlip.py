"""The port's EGNN interatomic potential (MLIP) against the JAX package's,
on the same Lennard-Jones batches with the JAX model's parameters converted,
and the repaired backwards of the port's segment-reduction Functions.

Tolerances, with their reasons:

* energies and forces (fp32): XLA and PyTorch sum in other orders through
  three EGNN layers, the heads and the position gradient, rtol 1e-4 and
  atol 1e-4 of the largest |value|;
* one MLIP train step: each parameter's gradient, a gradient of the
  force gradient, within 1e-4 of that tensor's largest fp32 gradient
  (1e-6 floor); the parameters after the first AdamW step at 1e-3 * lr,
  and at 2 * lr where a gradient is at the level of the two packages'
  differences (there the first step's sign follows fp32 noise);
* force equivariance: a rotation reorders fp32 sums, atol 1e-4 of the
  largest force;
* the repaired second derivatives: ``gradgradcheck`` in fp64 (the plain
  versions sum fp64 in fp64).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.datasets.lennard_jones import lennard_jones_data
from hydragnn_tpu.graphs.batching import collate as jax_collate
from hydragnn_tpu.graphs.batching import compute_pad_spec as jax_pad_spec
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models import init_model
from hydragnn_tpu.models import mlip as jmlip
from hydragnn_tpu.preprocess import apply_variables_of_interest
from hydragnn_tpu_torch.convert import batch_from_numpy, port_arrays
from hydragnn_tpu_torch.models import mlip
from hydragnn_tpu_torch.ops import fused_scatter as fs
from hydragnn_tpu_torch.ops import fused_softmax as fsm
from test_forces import MLIP_CONFIG

REL = 1e-4  # of the largest |value| of the compared tensor


def _config(head: str, layers: int = 3):
    cfg = copy.deepcopy(MLIP_CONFIG)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch["num_conv_layers"] = layers
    if head == "graph":
        cfg["NeuralNetwork"]["Variables_of_interest"]["type"] = ["graph"]
        arch["output_heads"] = {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                                          "num_headlayers": 2, "dim_headlayers": [16, 16]}}
    return cfg


class Setup:
    """A JAX EGNN MLIP (3 layers: two with coordinate updates), its jittered
    parameters, the port's model holding them, and a batch of four 8-atom
    LJ cells (periodic shifts, pad edges and pad nodes)."""

    def __init__(self, head: str):
        from hydragnn_tpu_torch.config import update_config

        cfg = _config(head)
        samples = lennard_jones_data(number_configurations=8, cells_per_dim=2, seed=3)
        samples = apply_variables_of_interest(samples, cfg)
        self.jaug = jax_update_config(copy.deepcopy(cfg), samples)
        self.aug = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
        self.jmodel = jax_create_model_config(self.jaug)
        self.nb = jax_collate(samples[:4], jax_pad_spec(samples, 4))
        self.jb = jax.tree.map(jnp.asarray, self.nb)
        # jittered: the coordinate gate's output layer starts at ~1e-3 scale
        # and the biases at 0, which would leave most terms untested
        variables = tpu.jitter_params(init_model(self.jmodel, self.nb), seed=1, scale=0.2)
        self.params = variables["params"]
        self.model = tpu.port_model_from_jax(self.aug, variables)
        self.batch = batch_from_numpy(self.nb)


@pytest.fixture(scope="module", params=["graph", "node"])
def setup(request):
    return Setup(request.param)


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, f"max|diff| {err:.3e} > {rel} x {scale:.3e}"


def test_egnn_energies_and_forces_match_jax(setup):
    jef = jmlip.make_energy_and_forces(setup.jmodel)
    je, jf = jef({"params": setup.params}, setup.jb)
    e, f = mlip.make_energy_and_forces(setup.model)(setup.batch)
    _close(e.numpy(), je)
    _close(f.numpy(), jf)
    assert bool((f[setup.batch.node_mask == 0] == 0).all())
    assert float(np.abs(np.asarray(jf)).max()) > 1e-3  # the forces are not trivial


def test_forces_are_equivariant_under_rotation(setup):
    """F(R x) = R F(x) and E(R x) = E(x): positions and periodic shift
    vectors rotated together."""
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = torch.from_numpy(q.astype(np.float32))
    b = setup.batch
    ef = mlip.make_energy_and_forces(setup.model)
    e0, f0 = ef(b)
    e1, f1 = ef(b.replace(pos=b.pos @ rot.T, edge_shifts=b.edge_shifts @ rot.T))
    _close(e1.numpy(), e0.numpy())
    _close(f1.numpy(), (f0 @ rot.T).numpy())


def test_energy_force_loss_matches_jax(setup):
    rng = np.random.default_rng(2)
    g, n = setup.batch.num_graphs, setup.batch.num_nodes
    ge = rng.normal(size=(g,)).astype(np.float32)
    fo = rng.normal(size=(n, 3)).astype(np.float32)
    spec = dataclasses.replace(setup.model.spec, energy_peratom_weight=0.5)
    jspec = dataclasses.replace(setup.jmodel.spec, energy_peratom_weight=0.5)
    jt, jtasks = jmlip.energy_force_loss(jspec, jnp.asarray(ge), jnp.asarray(fo), setup.jb)
    t, tasks = mlip.energy_force_loss(spec, torch.from_numpy(ge), torch.from_numpy(fo),
                                      setup.batch)
    np.testing.assert_allclose(float(t), float(jt), rtol=1e-6)
    np.testing.assert_allclose([float(x) for x in tasks], [float(x) for x in jtasks], rtol=1e-6)


@pytest.mark.parametrize("override,match", [
    ({"output_heads": {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                                 "num_headlayers": 1, "dim_headlayers": [8]},
                       "node": {"num_headlayers": 1, "dim_headlayers": [8], "type": "mlp"}}},
     "exactly one head"),
    ({"graph_pooling": "mean"}, "sum pooling"),
    ({"energy_weight": 0.0, "force_weight": 0.0}, "weights are zero"),
])
def test_mlip_spec_refusals(override, match):
    from hydragnn_tpu_torch.config import ModelSpec

    cfg = _config("graph" if "graph_pooling" in override else "node")
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(override)
    voi = cfg["NeuralNetwork"]["Variables_of_interest"]
    if "output_heads" in override:
        voi.update(type=["graph", "node"], output_index=[0, 0], output_dim=[1, 1])
    samples = apply_variables_of_interest(
        lennard_jones_data(number_configurations=2, cells_per_dim=2, seed=0), cfg)
    from hydragnn_tpu_torch.config import update_config

    spec = ModelSpec.from_config(update_config(cfg, tpu.port_samples(samples)))
    jspec = jax_create_model_config(jax_update_config(copy.deepcopy(cfg), samples)).spec
    with pytest.raises(ValueError, match=match):
        jmlip.validate_mlip_spec(jspec)
    with pytest.raises(ValueError, match=match):
        mlip.validate_mlip_spec(spec)


def test_mlip_relu_warns_and_edge_features_refused():
    from hydragnn_tpu_torch.config import ModelSpec, update_config

    cfg = _config("graph")
    cfg["NeuralNetwork"]["Architecture"]["activation_function"] = "relu"
    samples = tpu.port_samples(apply_variables_of_interest(
        lennard_jones_data(number_configurations=2, cells_per_dim=2, seed=0), cfg))
    with pytest.warns(UserWarning, match="piecewise-linear"):
        mlip.validate_mlip_spec(ModelSpec.from_config(update_config(cfg, samples)))
    cfg["NeuralNetwork"]["Architecture"]["edge_features"] = ["length"]
    with pytest.raises(ValueError, match="interatomic"):
        update_config(cfg, samples)


def _jax_mlip_grads(setup):
    """The JAX MLIP loss's parameter gradients (train-mode forward, forces
    from the inner ``jax.grad``), as in ``make_mlip_train_step``."""
    spec = setup.jmodel.spec
    efn = jmlip.make_graph_energy_fn(setup.jmodel)
    jb = setup.jb

    def loss(params):
        def total(pos):
            e = efn({"params": params}, pos, jb, True)
            return e.sum(), e

        (_, ge), gp = jax.value_and_grad(total, has_aux=True)(jb.pos)
        return jmlip.energy_force_loss(spec, ge, -gp * jb.node_mask[:, None], jb)[0]

    return jax.value_and_grad(loss)(setup.params)


def test_mlip_train_step_matches_jax(setup):
    from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
    from hydragnn_tpu.train.step import TrainState as JaxTrainState
    from hydragnn_tpu_torch.train.step import create_train_state

    opt_cfg = setup.jaug["NeuralNetwork"]["Training"]["Optimizer"]
    lr = float(opt_cfg["learning_rate"])
    jloss, jgrads = _jax_mlip_grads(setup)
    model = copy.deepcopy(setup.model)
    state = create_train_state(model, opt_cfg)
    metrics = mlip.make_mlip_train_step(model)(state, setup.batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-4)
    want = port_arrays(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    worst_diff = 0.0
    for name, g in want.items():
        scale = max(float(np.abs(g).max()), 1e-6)
        err = float(np.abs(got[name] - g).max())
        worst_diff = max(worst_diff, err)
        assert err <= REL * scale, f"{name}: max|grad diff| {err:.3e} > {REL} x {scale:.3e}"

    # the JAX step from the same parameters: AdamW's first update
    jopt = jax_select_optimizer(opt_cfg)
    params = jax.tree.map(jnp.asarray, setup.params)
    jstate = JaxTrainState(params=params, batch_stats={}, opt_state=jopt.init(params),
                           step=jnp.zeros((), jnp.int32))
    jnew, jmetrics = jmlip.make_mlip_train_step(setup.jmodel, jopt)(jstate, setup.jb)
    np.testing.assert_allclose(np.asarray(metrics["tasks_loss"]),
                               np.asarray(jmetrics["tasks_loss"]), rtol=1e-4, atol=1e-7)
    new = port_arrays(jax.tree.map(np.asarray, jnew.params))
    floor = 10 * worst_diff
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - new[name])
        noise = np.abs(want[name]) <= floor
        assert float(diff[~noise].max(initial=0.0)) <= 1e-3 * lr, name
        assert float(diff[noise].max(initial=0.0)) <= 2 * lr, name


def test_mlip_eval_step_head_sse_matches_jax(setup):
    from hydragnn_tpu.train.step import TrainState as JaxTrainState
    from hydragnn_tpu_torch.train.step import TrainState

    jstate = JaxTrainState(params=setup.params, batch_stats={}, opt_state=None,
                           step=jnp.zeros((), jnp.int32))
    jm = jmlip.make_mlip_eval_step(setup.jmodel)(jstate, setup.jb)
    m = mlip.make_mlip_eval_step(setup.model)(TrainState(setup.model, None), setup.batch)
    np.testing.assert_allclose(m["head_sse"].numpy(), np.asarray(jm["head_sse"]), rtol=1e-4)
    np.testing.assert_array_equal(m["head_count"].numpy(), np.asarray(jm["head_count"]))
    np.testing.assert_allclose(m["tasks_loss"].numpy(), np.asarray(jm["tasks_loss"]),
                               rtol=1e-4, atol=1e-7)
    assert not any(p.grad is not None for p in setup.model.parameters())


# -- the repaired backwards -----------------------------------------------------


def _graph():
    """Ids with repeats and an empty row, and their CSR views."""
    rng = np.random.default_rng(4)
    n, e = 7, 23
    s = torch.from_numpy(rng.integers(0, n, size=e).astype(np.int32))
    r = torch.from_numpy(rng.integers(0, n - 1, size=e).astype(np.int32))
    return n, e, s, r


def _ops():
    """Each repaired Function as ``(fn, input shapes)``; the gather-scatter
    sum once in ``h`` and once in ``h`` and its per-edge weight, and its
    transposed entry (the backward's) in ``dout`` and the weight."""
    n, e, s, r = _graph()
    w = torch.rand(e, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    return {
        "fused_segment_sum": (lambda x: fs.fused_segment_sum(x, r, n), [(e, 3)]),
        "gather_rows": (lambda x: fs.gather_rows(x, s), [(n, 3)]),
        "gather_scatter_sum": (lambda h: fs.gather_scatter_sum(h, s, r, n, weight=w), [(n, 3)]),
        "gather_scatter_sum_and_weight": (
            lambda h, we: fs.gather_scatter_sum(h, s, r, n, weight=we), [(n, 3), (e,)]),
        "gather_scatter_sum_bwd": (
            lambda d, we: fs.gather_scatter_sum_bwd(d, s, r, n, weight=we), [(n, 3), (e,)]),
        "segment_softmax": (lambda x: fsm.segment_softmax(x, r, n), [(e, 2)]),
    }


_FUNCTION_NODES = {"_SegmentSumBackward", "_GatherRowsBackward", "_GatherScatterSumBackward",
                   "_SegmentSoftmaxBackward"}
_ATOMIC_NODES = {"IndexAddBackward0", "IndexSelectBackward0", "IndexBackward0",
                 "IndexPutBackward0"}


def _node_names(t):
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("op", sorted(_ops()))
def test_repaired_backward_is_differentiable_on_port_functions(op):
    """The gradient of each Function, taken with ``create_graph=True``, is
    built from the port's Functions (on the card: the kernels) and not from
    a gather or ``index_add_`` that autograd would run with atomics; and its
    second derivative is right (``gradgradcheck`` in fp64)."""
    fn, shapes = _ops()[op]
    gen = torch.Generator().manual_seed(1)
    xs = tuple(torch.randn(sh, dtype=torch.float64, generator=gen, requires_grad=True)
               for sh in shapes)
    y = fn(*xs)
    # the upstream gradient carries a graph too, as the force loss's does
    # (for a linear Function the gradient depends on nothing else)
    dy = torch.randn(y.shape, dtype=torch.float64, generator=gen, requires_grad=True)
    grads = torch.autograd.grad(y, xs, dy, create_graph=True)
    for g in grads:
        names = _node_names(g)
        assert names & _FUNCTION_NODES, names
        assert not names & _ATOMIC_NODES, names
    assert torch.autograd.gradgradcheck(fn, xs, (dy,))


def test_repair_keeps_first_derivatives_and_cpu_launch_counts():
    """First derivatives equal autograd's of the plain versions; the CPU
    route counts no launch."""
    n, e, s, r = _graph()
    x = torch.randn(n, 5, generator=torch.Generator().manual_seed(3), requires_grad=True)
    before = dict(fs.LAUNCHES)
    got = torch.autograd.grad(fs.gather_scatter_sum(x, s, r, n).square().sum(), x)[0]
    want = torch.autograd.grad(fs.plain_gather_scatter_sum(x, s, r, n).square().sum(), x)[0]
    torch.testing.assert_close(got, want)
    got = torch.autograd.grad(fs.gather_rows(x, s).square().sum(), x)[0]
    want = torch.autograd.grad(x[s.long()].square().sum(), x)[0]
    torch.testing.assert_close(got, want)
    assert fs.LAUNCHES == before


def test_run_training_takes_the_mlip_steps(tmp_path):
    """``run_training`` on an MLIP config trains with the energy+force loss
    (the train loss falls, the evaluations run the MLIP eval step), and
    ``run_prediction`` serves the trained potential's head outputs, as the
    JAX package's does (no forces)."""
    from hydragnn_tpu_torch import run_prediction, run_training

    cfg = _config("graph", layers=2)
    cfg["NeuralNetwork"]["Architecture"]["hidden_dim"] = 8
    cfg["NeuralNetwork"]["Training"].update(num_epoch=4, batch_size=4)
    history = []
    state, model, aug = run_training(
        copy.deepcopy(cfg), samples=tpu.port_samples(lennard_jones_data(
            number_configurations=24, cells_per_dim=2, seed=5)),
        device="cpu", path=str(tmp_path), history=history)
    losses = [h["train_loss"] for h in history]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 4 * 4 and np.isfinite(history[-1]["val_loss"])
    error, _, trues, preds = run_prediction(copy.deepcopy(cfg), state, samples=tpu.port_samples(
        lennard_jones_data(number_configurations=8, cells_per_dim=2, seed=5)), device="cpu")
    assert np.isfinite(error) and len(preds) == 1 and preds[0].shape == trues[0].shape
    assert np.isfinite(preds[0]).all()
