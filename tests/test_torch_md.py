"""The port's MD integrators (``hydragnn_tpu_torch.md``) against the JAX
package's, on the same float32 states made with numpy.

Tolerances, with their reasons:

* velocity Verlet with an analytic LJ potential, 5 steps, dense and cell
  list: positions, velocities and forces within 1e-5 (absolute; forces
  are ~1e-2 here), energies within rtol 1e-5. The neighbour lists are the
  same arrays; the energy sums and their gradients differ in fp32 order
  only;
* 3 MD steps of an EGNN MLIP with the JAX model's parameters converted:
  positions and velocities within 1e-5, forces and energies within 1e-5 of
  their largest |value| (three EGNN layers and a gradient in fp32);
* energy conservation, Langevin and the NPT virial hold the port alone to
  the JAX package's own test thresholds (``tests/test_md.py``): the
  Langevin noise comes from a ``torch.Generator`` and cannot equal
  ``jax.random``'s draws.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu import md as jmd
from hydragnn_tpu_torch import md


def _lattice(k=6, a=2.2, seed=0):
    """The ``bench.py`` MD lattice at ``k**3`` atoms (``md_rollout.py --big``)."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*([np.arange(k)] * 3), indexing="ij"), -1)
    pos = (g.reshape(-1, 3) * a + a / 2 + 0.05 * rng.normal(size=(k**3, 3))).astype(np.float32)
    vel = (0.02 * rng.normal(size=(k**3, 3))).astype(np.float32)
    return pos, vel, np.eye(3, dtype=np.float32) * (k * a)


def _lj_jax(sigma=2.0, eps=0.02):
    def lj(p, s, r, sh, em):
        d = p[r] - p[s] + sh
        d2 = (d * d).sum(-1) + (1.0 - em)
        inv6 = (sigma**2 / d2) ** 3
        return 0.5 * jnp.sum(em * 4.0 * eps * (inv6 * inv6 - inv6))
    return lj


def _lj_torch(sigma=2.0, eps=0.02):
    def lj(p, s, r, sh, em):
        d = p[r.long()] - p[s.long()] + sh
        d2 = (d * d).sum(-1) + (1.0 - em)
        inv6 = (sigma**2 / d2) ** 3
        return 0.5 * torch.sum(em * 4.0 * eps * (inv6 * inv6 - inv6))
    return lj


def _assert_states_close(got, want, atol=1e-5):
    for field in ("pos", "vel", "forces"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=atol, err_msg=field)
    np.testing.assert_allclose(float(got.energy), float(want.energy), rtol=1e-5)
    assert int(got.n_edges) == int(want.n_edges)
    assert int(got.max_n_edges) == int(want.max_n_edges)


@pytest.mark.parametrize("neighbor", ["dense", "cell"])
def test_verlet_steps_match_jax(neighbor):
    pos, vel, cell = _lattice()
    n = pos.shape[0]
    pbc = np.ones(3, bool)
    kw = dict(cell=cell, pbc=pbc, neighbor=neighbor)
    jinit, jstep = jmd.make_md_step(_lj_jax(), np.ones(n, np.float32), 1e-3, 3.0, 60 * n, **kw)
    init, step = md.make_md_step(_lj_torch(), np.ones(n, np.float32), 1e-3, 3.0, 60 * n, **kw)
    jstate = jinit(jnp.asarray(pos), jnp.asarray(vel))
    state = init(torch.from_numpy(pos), torch.from_numpy(vel))
    _assert_states_close(state, jstate)
    for _ in range(5):
        jstate, state = jstep(jstate), step(state)
    _assert_states_close(state, jstate)
    assert 0 < int(state.max_n_edges) <= 60 * n


def test_velocity_verlet_conserves_energy():
    """A C1 pair potential (zero value and slope at the cutoff): the total
    energy drifts by under 5e-3 over 400 steps (``tests/test_md.py``)."""
    rng = np.random.default_rng(3)
    n, cutoff = 16, 1.5
    pos = torch.from_numpy(rng.uniform(0, 4.0, size=(n, 3)).astype(np.float32))
    vel = torch.from_numpy(rng.normal(scale=0.1, size=(n, 3)).astype(np.float32))
    masses = np.ones(n, np.float32)

    def energy(p, s, r, sh, em):
        vec = p[r.long()] - p[s.long()] + sh
        d = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-12)
        return 0.5 * torch.sum(em * 0.5 * (cutoff - d) ** 2)

    final, traj = md.run_md(energy, pos, vel, masses, dt=2e-3, n_steps=400, cutoff=cutoff,
                            max_edges=1024, record_every=40)
    e_tot = traj.energy.numpy() + np.array(
        [float(md.kinetic_energy(v, masses)) for v in traj.vel])
    drift = abs(e_tot[-1] - e_tot[0]) / max(abs(e_tot[0]), 1e-6)
    assert traj.pos.shape == (10, n, 3)
    assert np.all(np.isfinite(e_tot)) and drift < 5e-3, f"energy drift {drift:.2e}"
    assert int(final.max_n_edges) <= 1024


def test_run_md_rejects_remainder_steps():
    with pytest.raises(ValueError, match="multiple of record_every"):
        md.run_md(lambda *a: torch.zeros(()), torch.zeros(2, 3), torch.zeros(2, 3),
                  np.ones(2), dt=1e-3, n_steps=100, cutoff=1.0, max_edges=8, record_every=40)


def test_langevin_thermostat_equilibrates_to_target_temperature():
    """Starting cold, the kinetic temperature relaxes to the target k_B T
    (time average within 15%, ``tests/test_md.py``); a seeded generator
    repeats the trajectory."""
    rng = np.random.default_rng(4)
    n, cutoff, kt = 32, 1.5, 0.5
    pos = torch.from_numpy(rng.uniform(0, 5.0, size=(n, 3)).astype(np.float32))
    masses = np.ones(n, np.float32)

    def energy(p, s, r, sh, em):
        vec = p[r.long()] - p[s.long()] + sh
        d = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-12)
        return 0.5 * torch.sum(em * 0.5 * (cutoff - d) ** 2)

    init, step = md.make_langevin_step(energy, masses, dt=5e-3, cutoff=cutoff, max_edges=2048,
                                       temperature=kt, friction=2.0)

    def roll(steps):
        state, gen = init(pos, torch.zeros(n, 3)), torch.Generator().manual_seed(0)
        temps = []
        for i in range(steps):
            state, gen = step(state, gen)
            if i >= 200:
                temps.append(float(md.temperature_of(state.vel, masses)))
        return state, temps

    state, temps = roll(600)
    t_mean = float(np.mean(temps))
    assert abs(t_mean - kt) < 0.15 * kt, f"T={t_mean:.3f} vs target {kt}"
    again, _ = roll(600)
    assert torch.equal(again.pos, state.pos)


def test_npt_virial_matches_finite_difference():
    """The strain derivative (one ``autograd.grad`` in a scalar strain)
    against central differences of the scaled energy (``tests/test_md.py``
    thresholds); and the NPT step's pressure uses it."""
    rng = np.random.default_rng(11)
    k, a = 4, 2.1
    g = np.stack(np.meshgrid(*([np.arange(k)] * 3), indexing="ij"), -1)
    pos = torch.from_numpy(
        (g.reshape(-1, 3) * a + a / 2 + 0.03 * rng.normal(size=(k**3, 3))).astype(np.float32))
    cell = np.eye(3, dtype=np.float32) * (k * a)
    lj = _lj_torch(sigma=2.0, eps=0.05)
    s, r, sh, em, _ = md.dynamic_radius_graph(pos, 3.0, 8192, cell=cell, pbc=np.ones(3, bool))

    def u_of(eps):
        sc = 1.0 + eps
        return lj(sc * pos, s, r, sc * sh, em)

    eps = torch.zeros((), requires_grad=True)
    (geps,) = torch.autograd.grad(u_of(eps), eps)
    h = 1e-3
    fd = (float(u_of(torch.tensor(h))) - float(u_of(torch.tensor(-h)))) / (2 * h)
    assert float(geps) == pytest.approx(fd, rel=2e-3, abs=1e-3)

    init, _ = md.make_berendsen_npt_step(lj, np.ones(k**3, np.float32), 1e-3, 3.0, 8192,
                                         temperature=0.01, pressure=0.0)
    state = init(pos, torch.zeros_like(pos), cell)
    vol = float(np.linalg.det(cell))
    assert float(state.pressure) == pytest.approx(-float(geps) / (3.0 * vol), rel=1e-5)


def test_npt_barostat_matches_jax_steps():
    """Berendsen NPT steps (the dense rebuild, the virial, both couplings)
    against the JAX package's on the same compressed lattice."""
    pos, vel, cell = _lattice(k=5, a=2.05, seed=12)
    n = pos.shape[0]
    kw = dict(temperature=0.02, pressure=0.0, tau_t=0.1, tau_p=0.5, compressibility=1.0)
    jinit, jstep = jmd.make_berendsen_npt_step(_lj_jax(sigma=2.0, eps=0.05),
                                               np.ones(n, np.float32), 2e-3, 3.0, 8192, **kw)
    init, step = md.make_berendsen_npt_step(_lj_torch(sigma=2.0, eps=0.05),
                                            np.ones(n, np.float32), 2e-3, 3.0, 8192, **kw)
    jstate = jinit(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(cell))
    state = init(torch.from_numpy(pos), torch.from_numpy(vel), cell)
    for _ in range(3):
        jstate, state = jstep(jstate), step(state)
    for field in ("pos", "vel", "cell"):
        np.testing.assert_allclose(getattr(state, field).numpy(),
                                   np.asarray(getattr(jstate, field)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(state.pressure), float(jstate.pressure), rtol=1e-4)
    np.testing.assert_allclose(float(state.temperature), float(jstate.temperature), rtol=1e-4)


@pytest.mark.parametrize("neighbor", ["dense", "cell"])
def test_mlip_md_steps_match_jax(neighbor):
    """An EGNN MLIP's energy drives 3 velocity-Verlet steps on a periodic
    64-atom LJ cell (cutoff 5.0: a 3 x 3 x 3 grid for the cell list), the
    port holding the JAX model's parameters."""
    from hydragnn_tpu.config import update_config as jax_update_config
    from hydragnn_tpu.datasets.lennard_jones import lennard_jones_data
    from hydragnn_tpu.graphs.batching import PadSpec as JaxPadSpec
    from hydragnn_tpu.graphs.batching import collate as jax_collate
    from hydragnn_tpu.models import create_model_config as jax_create_model_config
    from hydragnn_tpu.models import init_model
    from hydragnn_tpu.preprocess import apply_variables_of_interest
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.graphs.batching import PadSpec, collate
    from test_forces import MLIP_CONFIG

    cfg = copy.deepcopy(MLIP_CONFIG)
    cfg["NeuralNetwork"]["Architecture"]["num_conv_layers"] = 3
    samples = apply_variables_of_interest(
        lennard_jones_data(number_configurations=2, cells_per_dim=4, seed=2), cfg)
    jaug = jax_update_config(copy.deepcopy(cfg), samples)
    aug = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
    jmodel = jax_create_model_config(jaug)
    s0 = samples[0]
    n, max_edges = s0.num_nodes, 1024
    jtemplate = jax.tree.map(jnp.asarray, jax_collate(
        samples[:1], JaxPadSpec(n_node=n + 8, n_edge=max_edges, n_graph=2)))
    variables = tpu.jitter_params(init_model(jmodel, jtemplate), seed=5, scale=0.2)
    model = tpu.port_model_from_jax(aug, variables)
    template = collate(tpu.port_samples(samples[:1]),
                       PadSpec(n_node=n + 8, n_edge=max_edges, n_graph=2))

    kw = dict(cell=s0.cell.astype(np.float32), pbc=s0.pbc, pad_id=n + 7, neighbor=neighbor)
    masses = np.ones(n, np.float32)
    jinit, jstep = jmd.make_md_step(jmd.mlip_energy_fn(jmodel, variables, jtemplate), masses,
                                    1e-2, 5.0, max_edges, **kw)
    init, step = md.make_md_step(md.mlip_energy_fn(model, template), masses, 1e-2, 5.0,
                                 max_edges, **kw)
    pos0 = s0.pos.astype(np.float32)
    jstate = jinit(jnp.asarray(pos0), jnp.zeros((n, 3), jnp.float32))
    state = init(torch.from_numpy(pos0), torch.zeros(n, 3))
    for _ in range(3):
        jstate, state = jstep(jstate), step(state)
    for field in ("pos", "vel"):
        np.testing.assert_allclose(getattr(state, field).numpy(),
                                   np.asarray(getattr(jstate, field)), rtol=0, atol=1e-5)
    f_scale = float(np.abs(np.asarray(jstate.forces)).max())
    assert f_scale > 1e-3  # the potential moves the atoms
    np.testing.assert_allclose(state.forces.numpy(), np.asarray(jstate.forces), rtol=0,
                               atol=1e-5 * f_scale)
    np.testing.assert_allclose(float(state.energy), float(jstate.energy), rtol=1e-5)
    assert int(state.n_edges) == int(jstate.n_edges) <= max_edges


def test_md_config_block_matches_jax():
    """``update_config`` fills the ``MD`` block with ``MDConfig``'s defaults,
    as the JAX package does, and refuses what ``MDConfig`` refuses."""
    from hydragnn_tpu.config import update_config as jax_update_config
    from hydragnn_tpu.datasets.lennard_jones import lennard_jones_data
    from hydragnn_tpu.preprocess import apply_variables_of_interest
    from hydragnn_tpu_torch.config import update_config
    from test_forces import MLIP_CONFIG

    cfg = copy.deepcopy(MLIP_CONFIG)
    samples = apply_variables_of_interest(
        lennard_jones_data(number_configurations=2, cells_per_dim=2, seed=0), cfg)
    got = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))["MD"]
    assert got == jax_update_config(copy.deepcopy(cfg), samples)["MD"] == md.md_config_defaults()
    assert md.MDConfig.from_config({"MD": {"neighbor": "cell"}}).step_kwargs()["neighbor"] == "cell"
    for block, match in (({"nieghbor": "cell"}, "Unknown MD"), ({"neighbor": "grid"}, "neighbor"),
                         ({"capacity_factor": 1.0}, "capacity_factor"),
                         ({"fused_cell_list": "yes"}, "fused_cell_list")):
        with pytest.raises(ValueError, match=match):
            update_config({**copy.deepcopy(cfg), "MD": block}, tpu.port_samples(samples))
