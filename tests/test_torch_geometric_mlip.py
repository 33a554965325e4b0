"""PAINN and MACE as interatomic potentials (MLIPs) in the port against the
JAX package, on the same Lennard-Jones batches with the JAX model's
parameters converted; their force equivariance; and DimeNet's position
gradients, which must stay finite (the JAX package's
``tests/test_forces.py::test_dimenet_position_gradients_finite``, re-run on
the port) and, through the spherical Bessel functions' analytic
derivative, their gradient too.

The configuration is ``tests/test_forces.py``'s ``MLIP_CONFIG`` (hidden 16,
energy + 10 x force loss, silu, add pooling) with 3 conv layers, a node or
a graph head, and ``examples/oc20/train.py``'s irreps orders for MACE
(``max_ell`` 2, ``node_max_ell`` 1, ``correlation`` 2), as
``tests/test_torch_mlip.py`` holds the EGNN.

Tolerances, those of ``tests/test_torch_mlip.py``: energies and forces
within 1e-4 of the largest |value| (XLA and PyTorch sum in other orders
through three layers, the heads and the position gradient); each
parameter's gradient of the energy + force loss (a gradient of the force
gradient) within 1e-4 of that tensor's largest; the parameters after one
AdamW step at 1e-3 x lr (2 x lr where a gradient is at the level of the
two packages' differences); force equivariance at 1e-4 of the largest
force.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
import test_torch_mlip as egnn_mlip
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.datasets.lennard_jones import lennard_jones_data
from hydragnn_tpu.graphs.batching import collate as jax_collate
from hydragnn_tpu.graphs.batching import compute_pad_spec as jax_pad_spec
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models import init_model
from hydragnn_tpu.preprocess import apply_variables_of_interest
from hydragnn_tpu_torch.convert import batch_from_numpy
from hydragnn_tpu_torch.models import mlip

ARCHS = {"PAINN": {"num_radial": 6},
         "MACE": {"num_radial": 6, "max_ell": 2, "node_max_ell": 1, "correlation": 2}}


class Setup:
    """A JAX MLIP of ``arch`` (3 layers), its jittered parameters, the port's
    model holding them, and a batch of four 8-atom LJ cells (periodic
    shifts, pad edges and pad nodes)."""

    def __init__(self, arch: str, head: str):
        from hydragnn_tpu_torch.config import update_config

        cfg = egnn_mlip._config(head)
        cfg["NeuralNetwork"]["Architecture"].update(mpnn_type=arch, **ARCHS[arch])
        samples = lennard_jones_data(number_configurations=8, cells_per_dim=2, seed=3)
        samples = apply_variables_of_interest(samples, cfg)
        self.jaug = jax_update_config(copy.deepcopy(cfg), samples)
        self.aug = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
        self.jmodel = jax_create_model_config(self.jaug)
        self.nb = jax_collate(samples[:4], jax_pad_spec(samples, 4))
        self.jb = jax.tree.map(jnp.asarray, self.nb)
        variables = tpu.jitter_params(init_model(self.jmodel, self.nb), seed=1, scale=0.2)
        self.params = variables["params"]
        self.model = tpu.port_model_from_jax(self.aug, variables)
        self.batch = batch_from_numpy(self.nb)


@pytest.fixture(scope="module", params=[(a, h) for a in ARCHS for h in ("node", "graph")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def setup(request):
    return Setup(*request.param)


def test_energies_and_forces_match_jax(setup):
    egnn_mlip.test_egnn_energies_and_forces_match_jax(setup)


def test_forces_are_equivariant_under_rotation(setup):
    egnn_mlip.test_forces_are_equivariant_under_rotation(setup)


def test_mlip_train_step_matches_jax(setup):
    """The energy + force loss, its parameter gradients (through the force
    backward's second derivative on the segment-sum Functions) and one
    AdamW step."""
    egnn_mlip.test_mlip_train_step_matches_jax(setup)


def test_mlip_eval_step_head_sse_matches_jax(setup):
    egnn_mlip.test_mlip_eval_step_head_sse_matches_jax(setup)


def test_force_loss_gradient_reaches_every_conv_layer(setup):
    """The force term alone (energy weight 0) trains every conv layer: its
    gradient is a gradient of the position gradient, which the second
    derivatives of the port's Functions carry."""
    import dataclasses

    model = copy.deepcopy(setup.model)
    model.spec = dataclasses.replace(model.spec, energy_weight=0.0)
    b, pos = mlip._position_leaf(setup.batch)
    ge = mlip.graph_energy(model.spec, model(b, train=True)[0], setup.batch)
    (gp,) = torch.autograd.grad(ge.sum(), pos, create_graph=True)
    tot, _ = mlip.energy_force_loss(model.spec, ge, -gp * setup.batch.node_mask[:, None],
                                    setup.batch)
    tot.backward()
    for i in range(model.spec.num_conv_layers):
        grads = [p.grad for n, p in model.named_parameters()
                 if n.startswith(f"graph_convs.{i}.") and p.grad is not None]
        assert grads and max(float(g.abs().max()) for g in grads) > 0, f"layer {i}"


def test_dimenet_position_gradients_finite():
    """``tests/test_forces.py::test_dimenet_position_gradients_finite`` on
    the port (``tests/test_arch_forward.py::build_arch``'s DimeNet, its
    parameters the JAX init's): the position gradient of the graph energy is
    finite, equal to the JAX package's, and nonzero on real nodes; and the
    gradient of that gradient (what force training takes) is finite too."""
    from test_arch_forward import build_arch

    jmodel, jbatch = build_arch("DimeNet")
    # init_model's variables, from a jitted init (the same draws, in a third
    # of the time)
    variables = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False))(jbatch)

    def energy(pos):
        out = jmodel.apply(variables, jbatch.replace(pos=pos), train=False)
        return (out[0][:, 0] * jbatch.graph_mask).sum()

    want = np.asarray(jax.jit(jax.grad(energy))(jbatch.pos))
    model = _port_dimenet(variables)
    batch = batch_from_numpy(jax.tree.map(np.array, jbatch))
    pos = batch.pos.clone().requires_grad_()
    out = model(batch.replace(pos=pos))
    e = (out[0][:, 0] * batch.graph_mask).sum()
    (g,) = torch.autograd.grad(e, pos, create_graph=True)
    assert torch.isfinite(g).all(), "NaN position gradients"
    real = batch.node_mask > 0
    assert float(g.detach()[real].abs().max()) > 0
    np.testing.assert_allclose(g.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    (g2,) = torch.autograd.grad((g * g).sum(), pos)
    assert torch.isfinite(g2).all(), "NaN in the gradient of the position gradient"


def _port_dimenet(variables):
    """The port's model of ``build_arch("DimeNet")``, holding ``variables``."""
    import test_arch_forward
    from hydragnn_tpu.config import update_config as jupd
    from hydragnn_tpu.datasets import deterministic_graph_data
    from hydragnn_tpu_torch.config import update_config

    cfg = copy.deepcopy(test_arch_forward.CI_CONFIG)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(mpnn_type="DimeNet", num_gaussians=10, num_filters=8, num_radial=5,
                envelope_exponent=5, task_weights=[1.0, 1.0])
    cfg["NeuralNetwork"]["Variables_of_interest"] = {
        "input_node_features": [0], "output_index": [0, 1], "type": ["graph", "node"],
        "denormalize_output": False}
    arch["output_heads"]["node"] = {"num_headlayers": 1, "dim_headlayers": [4], "type": "mlp"}
    samples = apply_variables_of_interest(
        deterministic_graph_data(number_configurations=8, seed=13), cfg)
    jaug = jupd(copy.deepcopy(cfg), samples)
    aug = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
    assert aug["NeuralNetwork"]["Architecture"]["input_dim"] == \
        jaug["NeuralNetwork"]["Architecture"]["input_dim"]
    return tpu.port_model_from_jax(aug, variables)
