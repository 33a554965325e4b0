"""The port's six optax optimizers (``train/optimizer.py``: RMSprop,
Adagrad, Adadelta, Adamax, LAMB, FusedLAMB) against the JAX package's
``select_optimizer`` (optax) on the CPU: the same parameters, one step and
ten steps of a fixed gradient sequence drawn from a numpy seed, LAMB with
and without an explicit ``weight_decay``. The parameters include a 0-d
one (GIN's ``eps``) and an all-zero one (LAMB's trust ratio is 1 there).

Bounds: the parameters within rtol 1e-6 after one step and 1e-5 after ten
(atol 1e-7 for the entries near 0: the update moves each by about the
learning rate 1e-2, so 1e-7 is float32 rounding of the step itself);
optax and the port compute the same formula in float32, XLA and PyTorch
round square roots, powers and norms their own ways.

The class the card uses (a 0-d float64 learning-rate tensor) run on CPU
tensors gives the float-rate class's parameters and state bit for bit, and
``load_optimizer_state`` restores each optimizer's state into a fresh one.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu_torch.train.optimizer import (load_optimizer_state, select_optimizer,
                                                set_learning_rate)

SHAPES = {"w": (5, 3), "b": (3,), "eps": (), "zero": (4,)}
LR = 1e-2
OPTIMIZERS = [
    {"type": "RMSProp"},
    {"type": "Adagrad"},
    {"type": "Adadelta"},
    {"type": "Adamax"},
    {"type": "LAMB"},
    {"type": "FusedLAMB"},
    {"type": "LAMB", "weight_decay": 0.05},
]
IDS = ["rmsprop", "adagrad", "adadelta", "adamax", "lamb", "fusedlamb", "lamb_wd"]


def initial_params(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    out["zero"] = np.zeros(SHAPES["zero"], np.float32)
    return out


def gradient_sequence(n: int, seed: int = 1) -> list[dict]:
    rng = np.random.default_rng(seed)
    seq = []
    for t in range(n):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
        if t == 0:
            g["b"][0] = 0.0  # a zero gradient entry (Adagrad's accumulator stays > 0)
        seq.append(g)
    return seq


def optax_run(cfg: dict, grads: list[dict]) -> dict:
    opt = jax_select_optimizer({**cfg, "learning_rate": LR})
    params = {k: jnp.asarray(v) for k, v in initial_params().items()}
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def port_params():
    return {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in initial_params().items()}


def port_run(cfg: dict, grads: list[dict], rate=None):
    params = port_params()
    opt = select_optimizer({**cfg, "learning_rate": LR}, params.values())
    if rate is not None:
        for group in opt.param_groups:
            group["lr"] = rate
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return params, opt


@pytest.mark.parametrize("cfg", OPTIMIZERS, ids=IDS)
@pytest.mark.parametrize("steps,rtol", [(1, 1e-6), (10, 1e-5)], ids=["one_step", "ten_steps"])
def test_optimizer_matches_optax(cfg, steps, rtol):
    grads = gradient_sequence(steps)
    want = optax_run(cfg, grads)
    got, _ = port_run(cfg, grads)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=rtol, atol=1e-7,
                                   err_msg=f"{cfg} {k} after {steps} steps")
    moved = max(float(np.abs(want[k] - initial_params()[k]).max()) for k in want)
    assert moved > 1e-6, "the steps must move the parameters"


@pytest.mark.parametrize("cfg", OPTIMIZERS, ids=IDS)
def test_tensor_rate_is_bit_equal_to_float_rate(cfg):
    grads = gradient_sequence(4)
    a, opt_a = port_run(cfg, grads)
    b, opt_b = port_run(cfg, grads, rate=torch.tensor(LR, dtype=torch.float64))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for sa, sb in zip(opt_a.state.values(), opt_b.state.values()):
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key


@pytest.mark.parametrize("cfg", OPTIMIZERS, ids=IDS)
def test_state_reload_continues_bit_for_bit(cfg):
    """Two steps, a state dict, two more steps: a fresh optimizer loaded
    from the state dict over copies of the parameters takes the same two
    steps, the learning rate halved in both."""
    grads = gradient_sequence(4)
    params, opt = port_run(cfg, grads[:2])
    saved = copy.deepcopy(opt.state_dict())
    twins = {k: torch.nn.Parameter(p.detach().clone()) for k, p in params.items()}
    fresh = select_optimizer({**cfg, "learning_rate": 1.0}, twins.values())
    load_optimizer_state(fresh, saved)
    assert float(fresh.param_groups[0]["lr"]) == LR
    for o in (opt, fresh):
        set_learning_rate(o, LR / 2)
    for g in grads[2:]:
        for ps, o in ((params, opt), (twins, fresh)):
            for k, p in ps.items():
                p.grad = torch.from_numpy(g[k].copy())
            o.step()
    for k in params:
        assert torch.equal(params[k], twins[k]), k


def test_optimizer_defaults_are_optax():
    """The hyperparameters the port fixes are optax's signature defaults."""
    import inspect

    sig = {name: inspect.signature(getattr(optax, name)).parameters
           for name in ("rmsprop", "adagrad", "adadelta", "adamax", "lamb")}
    params = port_params()
    for cfg, name, keys in (({"type": "RMSProp"}, "rmsprop", ("decay", "eps")),
                            ({"type": "Adadelta"}, "adadelta", ("rho", "eps")),
                            ({"type": "Adamax"}, "adamax", ("b1", "b2", "eps")),
                            ({"type": "LAMB"}, "lamb", ("b1", "b2", "eps", "weight_decay")),
                            ({"type": "Adagrad"}, "adagrad", ("eps",))):
        group = select_optimizer({**cfg, "learning_rate": LR}, params.values()).param_groups[0]
        for key in keys:
            assert group[key] == sig[name][key].default, (name, key)
    acc = select_optimizer({"type": "Adagrad", "learning_rate": LR}, params.values())
    init = sig["adagrad"]["initial_accumulator_value"].default
    assert all(float(s["sum_of_squares"].flatten()[0]) == pytest.approx(init)
               for s in acc.state.values() if s["sum_of_squares"].numel())
    assert jax.devices()[0].platform == "cpu"
