"""Population training in the port (``hydragnn_tpu_torch/train/population.py``)
against the JAX package and against its own single states, on the CPU.

Against the JAX package: each member, over several steps, against the JAX
package's PLAIN single-member K = 1 step with that member's
hyperparameters (never against the JAX package's vmapped population, which
does not bit-match its own sequential runs on this CPU). Tolerances, those
of the port's single-state step tests (``test_torch_train_step.py``): each
step's loss and per-task losses at rtol 1e-4 / atol 1e-6, and the
parameters after the first step within ``1e-3 * lr`` of the JAX state
(``2 * lr`` where the gradients are at fp32 noise, where Adam's first step
is decided by the noise).

Within the port: the vmapped population against sequential single states
(the capturable optimizers, the non-finite guard) with each member's
hyperparameters, bit for bit on the CPU's plain versions: every batched
kernel folds the members into its channels (each channel sums in its own
order), and the dense products and the train-mode batch norm run once per
member (``models.common.member_exact``), so nothing is summed in another
order.

The batching rules of B1 (forward, first and second derivative), B2, the
row gather, B3, B4 and DimeNet's spherical Bessel function, through the
plain versions, against a loop over the members, bit for bit.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.optimizer import set_hyperparam, set_learning_rate
from hydragnn_tpu.train.step import make_weighted_train_step as jax_weighted_step
from hydragnn_tpu_torch.convert import batch_from_numpy, load_jax_population
from hydragnn_tpu_torch.train import population as P
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.step import (TrainState, make_train_step,
                                           make_weighted_train_step)
from test_torch_train_step import (GRAD_TOL, Setup, _assert_params_close, four_head_config,
                                   single_head_config)

STEPS = 3


def _gat_config():
    cfg = single_head_config()
    cfg["NeuralNetwork"]["Architecture"].update(mpnn_type="GAT", dropout=0.0)
    return cfg


def _decay_config():
    cfg = single_head_config()
    cfg["NeuralNetwork"]["Training"]["Optimizer"]["weight_decay"] = 1e-4
    return cfg


_SETUPS = {"gin": single_head_config, "gat": _gat_config, "decay": _decay_config,
           "four_heads": four_head_config}


@functools.lru_cache(maxsize=None)
def setup(name: str) -> Setup:
    return Setup(_SETUPS[name]())


def _stacked(tree, n: int):
    return {k: _stacked(v, n) if isinstance(v, dict) else np.stack([np.asarray(v)] * n)
            for k, v in tree.items()}


def _population_from_jax(s: Setup, n: int, **hyper) -> P.PopulationState:
    """N members, each the JAX state's parameters and statistics."""
    pstate = P.create_population_state(copy.deepcopy(s.aug), n, device="cpu", **hyper)
    return load_jax_population(pstate, _stacked(tpu.numpy_tree(s.jstate.params), n),
                               _stacked(tpu.numpy_tree(s.jstate.batch_stats), n))


# -- the population against the JAX package's plain single-member step ---------

CASES = {
    # name: (setup, population keywords, JAX member state edits)
    "learning_rates": ("gin", {"learning_rates": [0.02, 0.005, 0.01]}, None),
    "weight_decays": ("decay", {"learning_rates": [0.02] * 3,
                                "weight_decays": [1e-4, 0.05, 0.0]}, None),
    "task_weights": ("four_heads", {}, [[20.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0],
                                        [1.0, 5.0, 0.0, 2.0]]),
    "superstep_k2": ("gin", {"learning_rates": [0.02, 0.005]}, None),
    "diverged_member": ("gin", {"learning_rates": [0.02, 1e30]}, None),
    "gat": ("gat", {"learning_rates": [0.02, 0.005]}, None),
}


def _jax_members(s: Setup, hyper: dict, weights):
    """Each member's JAX state (the converted init with its hyperparameters)
    and its plain K = 1 step."""
    n = len(weights) if weights is not None else len(hyper["learning_rates"])
    states = []
    for i in range(n):
        opt_state = s.jstate.opt_state
        if "learning_rates" in hyper:
            opt_state = set_learning_rate(opt_state, hyper["learning_rates"][i])
        if "weight_decays" in hyper:
            opt_state = set_hyperparam(opt_state, "weight_decay", hyper["weight_decays"][i])
        states.append(s.jstate._replace(opt_state=opt_state))
    if weights is None:
        return states, [s.jstep] * n
    wstep = jax_weighted_step(s.jmodel, jax_select_optimizer(s.opt_cfg))
    rows = [P._normalize_task_weights(w, len(w)) for w in weights]
    return states, [functools.partial(lambda st, b, w: wstep(st, b, w), w=jnp.asarray(r))
                    for r in rows]


@pytest.mark.parametrize("case", sorted(CASES))
def test_population_members_match_jax_single_member_steps(case):
    """Every member, step by step, against the JAX package's plain K = 1
    step with its hyperparameters from the same state: the losses at every
    step, the parameters after the first. ``diverged_member``: lr 1e30
    diverges after its first update; the port reverts it (``skipped``) and
    keeps it at that first update, the JAX state after its first step.
    ``superstep_k2``: the population through ``make_superstep(step, 2)``
    over the bucket-major plan of K = 2, against K = 1 steps over that
    plan."""
    name, hyper, weights = CASES[case]
    s = setup(name)
    jstates, jsteps = _jax_members(s, hyper, weights)
    n = len(jstates)
    pstate = _population_from_jax(s, n, **hyper)
    if weights is not None:
        step = P.make_population_step(task_weights=[
            P._normalize_task_weights(w, len(w)) for w in weights])
    else:
        step = P.make_population_step()
    batches = s.batches[:STEPS]
    if case == "superstep_k2":
        from hydragnn_tpu.datasets import deterministic_graph_data
        from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jl
        from hydragnn_tpu_torch.train.superstep import make_superstep

        # Setup's samples, the bucket-major K = 2 plan of its train split
        loader = jl(copy.deepcopy(s.cfg), samples=deterministic_graph_data(
            number_configurations=100, seed=7))[0]
        loader.set_superstep(2)
        batches = list(loader)[:2 * STEPS]
        superstep = make_superstep(step, 2)
        blocks = [batches[i:i + 2] for i in range(0, len(batches), 2)]
        metrics = [m for blk in blocks
                   for m in superstep(pstate, [batch_from_numpy(b) for b in blk])]
    else:
        metrics = []
        first = None
        for t, b in enumerate(batches):
            metrics.append(step(pstate, batch_from_numpy(b)))
            if t == 0:
                first = [P.member_state(pstate, i) for i in range(n)]
    skips = []
    first_j = []
    for i in range(n):
        js, member_skips = jstates[i], []
        for t, b in enumerate(batches):
            new, jm = jsteps[i](js, jax.tree.map(jnp.asarray, b))
            finite = np.isfinite(float(jm["loss"])) and all(
                np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(new.params))
            member_skips.append(int(not finite))
            if finite:
                np.testing.assert_allclose(float(metrics[t]["loss"][i]), float(jm["loss"]),
                                           **GRAD_TOL, err_msg=f"{case} member {i} step {t}")
                np.testing.assert_allclose(metrics[t]["tasks_loss"][i].numpy(),
                                           np.asarray(jm["tasks_loss"]), **GRAD_TOL)
                js = new
            if t == 0:
                first_j.append(js)
        skips.append(member_skips)
    got = torch.stack([m["skipped"] for m in metrics]).T.tolist()
    assert got == skips, (got, skips)
    if case == "diverged_member":
        assert skips[1][0] == 0 and all(skips[1][1:]) and not any(skips[0])
        # frozen at its first update: what the JAX member is after step 0
        _assert_params_close(P.member_state(pstate, 1).model, first_j[1], "frozen member:")
    if case != "superstep_k2":
        for i in range(n):
            _assert_params_close(first[i].model, first_j[i], f"{case} member {i}, step 1:")


# -- the population against the port's own single states ------------------------


def _sequential(s: Setup, hyper: dict, i: int, batches, optimizer: dict | None = None):
    """Member ``i`` alone: the converted init, a capturable optimizer with its
    hyperparameters, the guarded plain step (a non-finite step reverts)."""
    from hydragnn_tpu_torch.resilience import wrap_step_with_guard

    cfg = dict(optimizer or s.opt_cfg)
    if "learning_rates" in hyper:
        cfg["learning_rate"] = hyper["learning_rates"][i]
    if "weight_decays" in hyper:
        cfg["weight_decay"] = hyper["weight_decays"][i]
    model = s.port_model()
    state = TrainState(model, select_optimizer(cfg, model.parameters(), capturable=True))
    step = wrap_step_with_guard(make_train_step())
    return state, [step(state, batch_from_numpy(b)) for b in batches]


def _assert_member_equal(pstate, i: int, state: TrainState, what: str):
    mem = P.member_state(pstate, i)
    for (name, a), b in zip(state.model.state_dict().items(), mem.model.state_dict().values()):
        assert torch.equal(a, b), f"{what}: {name}"
    for p, q in zip(state.model.parameters(), mem.model.parameters()):
        for key, v in state.optimizer.state[p].items():
            assert torch.equal(v, mem.optimizer.state[q][key]), f"{what}: optimizer {key}"


@pytest.mark.parametrize("name,optimizer", [
    ("gin", {"type": "AdamW", "learning_rate": 0.02}),
    ("gin", {"type": "SGD", "learning_rate": 0.05}),
    ("gin", {"type": "LAMB", "learning_rate": 0.02, "weight_decay": 0.01}),
    ("gin", {"type": "Adagrad", "learning_rate": 0.02}),
    ("gat", {"type": "AdamW", "learning_rate": 0.02}),
])
def test_population_bit_equals_sequential_single_states(name, optimizer):
    """Three members (one at lr 1e30, diverging after its first update)
    stepped as one population: every member's parameters, statistics,
    optimizer state and per-step metrics equal its sequential guarded
    single state's, bit for bit."""
    s = setup(name)
    hyper = {"learning_rates": [optimizer["learning_rate"], optimizer["learning_rate"] / 4, 1e30]}
    aug = copy.deepcopy(s.aug)
    aug["NeuralNetwork"]["Training"]["Optimizer"] = dict(optimizer)
    pstate = P.create_population_state(aug, 3, device="cpu", **hyper)
    load_jax_population(pstate, _stacked(tpu.numpy_tree(s.jstate.params), 3),
                        _stacked(tpu.numpy_tree(s.jstate.batch_stats), 3))
    step = P.make_population_step()
    batches = s.batches[:STEPS]
    metrics = [step(pstate, batch_from_numpy(b)) for b in batches]
    assert [int(m["skipped"][2]) for m in metrics] == [0] + [1] * (STEPS - 1)
    for i in range(3):
        state, seq = _sequential(s, hyper, i, batches, optimizer)
        for t, m in enumerate(seq):
            for key in ("loss", "tasks_loss", "num_graphs", "skipped"):
                assert torch.equal(m[key], metrics[t][key][i]), (i, t, key)
        _assert_member_equal(pstate, i, state, f"{name} {optimizer['type']} member {i}")


def test_weighted_step_and_per_member_decays_bit_equal_single_states():
    """``make_weighted_train_step`` with the spec's normalized weights is the
    static step's bits; per-member task weights and weight decays in one
    population give each member its single state's bits."""
    s = setup("four_heads")
    b = batch_from_numpy(s.batches[0])
    spec_w = torch.tensor(s.port_model().spec.task_weights, dtype=torch.float32)
    a, w = s.port_model(), s.port_model()
    sa = TrainState(a, select_optimizer(s.opt_cfg, a.parameters(), capturable=True))
    sw = TrainState(w, select_optimizer(s.opt_cfg, w.parameters(), capturable=True))
    ma, mw = make_train_step()(sa, b), make_weighted_train_step()(sw, b, spec_w)
    assert torch.equal(ma["loss"], mw["loss"])
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), w.parameters()))

    rows = [[20.0, 1.0, 1.0, 1.0], [1.0, 3.0, 0.5, 1.0]]
    decays = [1e-4, 0.05]
    aug = copy.deepcopy(s.aug)
    aug["NeuralNetwork"]["Training"]["Optimizer"]["weight_decay"] = 1e-4
    pstate = P.create_population_state(aug, 2, device="cpu", weight_decays=decays)
    load_jax_population(pstate, _stacked(tpu.numpy_tree(s.jstate.params), 2),
                        _stacked(tpu.numpy_tree(s.jstate.batch_stats), 2))
    norm = [P._normalize_task_weights(r, 4) for r in rows]
    step = P.make_population_step(task_weights=norm)
    for bb in s.batches[:2]:
        step(pstate, batch_from_numpy(bb))
    for i in range(2):
        m = s.port_model()
        cfg = dict(s.opt_cfg, weight_decay=decays[i])
        st = TrainState(m, select_optimizer(cfg, m.parameters(), capturable=True))
        wstep = make_weighted_train_step()
        for bb in s.batches[:2]:
            wstep(st, batch_from_numpy(bb), torch.tensor(norm[i], dtype=torch.float32))
        _assert_member_equal(pstate, i, st, f"weighted member {i}")


# -- batching rules ------------------------------------------------------------


def _graph(seed: int = 0, n: int = 12, e: int = 40):
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.integers(0, n, e))
    r = torch.from_numpy(rng.integers(0, n, e))
    return rng, s, r, n


@pytest.mark.parametrize("weight", ["none", "edge", "channel", "edge_batched",
                                    "channel_batched"])
def test_gather_scatter_rule_forward_grad_and_second_derivative(weight):
    """B1 under ``vmap`` (members folded into the channels, one call)
    against a loop over the members: the output, the gradients with respect
    to ``h`` and a batched weight, and the second derivative (the gradient
    of a gradient norm), bit for bit."""
    from hydragnn_tpu_torch.ops.fused_scatter import gather_scatter_sum

    rng, s, r, n = _graph()
    m, c = 3, 5
    h = torch.from_numpy(rng.normal(size=(m, n, c))).requires_grad_(True)
    w = {"none": None, "edge": rng.normal(size=(40,)), "channel": rng.normal(size=(40, c)),
         "edge_batched": rng.normal(size=(m, 40)),
         "channel_batched": rng.normal(size=(m, 40, c))}[weight]
    batched_w = weight.endswith("batched")
    w = None if w is None else torch.from_numpy(w).requires_grad_(batched_w)

    def derivatives(out, hh, ww):
        """The gradients of ``sum(out)`` with respect to ``h`` and a
        batched weight, and those of a loss of the first derivative with
        respect to ``h`` (kept in the graph): the second derivative."""
        params = [hh] + ([ww] if ww is not None else [])
        first = torch.autograd.grad(out.sum(), params, retain_graph=True)
        g, = torch.autograd.grad((out ** 2).sum(), hh, create_graph=True)
        return first, g, torch.autograd.grad((g ** 2).sum(), params)

    in_w = 0 if batched_w else None
    out = torch.func.vmap(lambda hh, ww: gather_scatter_sum(hh, s, r, n, weight=ww),
                          in_dims=(0, in_w))(h, w)
    first, g, second = derivatives(out, h, w if batched_w else None)
    for i in range(m):
        hi = h.detach()[i].clone().requires_grad_(True)
        wi = None if w is None else (w.detach()[i] if batched_w else w.detach()).clone()
        if wi is not None and batched_w:
            wi.requires_grad_(True)
        oi = gather_scatter_sum(hi, s, r, n, weight=wi)
        first_i, gi, second_i = derivatives(oi, hi, wi if batched_w else None)
        assert torch.equal(out[i], oi) and torch.equal(g[i], gi)
        for a, b in zip(first, first_i):
            assert torch.equal(a[i], b)
        assert torch.equal(second[0][i], second_i[0])
        if weight == "edge_batched":
            # the weight's second-order gradient meets it at two uses, whose
            # per-channel parts the folded form adds before summing each
            # edge's channels (one association); alone, each use sums its
            # channels first: the same terms, associated otherwise
            torch.testing.assert_close(second[1][i], second_i[1], rtol=1e-13, atol=0)
        elif batched_w:
            assert torch.equal(second[1][i], second_i[1])


@pytest.mark.parametrize("op", ["segment_sum", "gather_rows", "segment_softmax",
                                "masked_softmax", "spherical_jn"])
def test_batching_rules_match_a_loop_over_members(op):
    """B2, the row gather, B3, B4 and DimeNet's spherical Bessel function
    under ``vmap`` against a loop over the members: outputs and gradients,
    bit for bit; a batched index input raises."""
    from hydragnn_tpu_torch.models.spherical import spherical_jn
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.ops import fused_softmax as fsm

    rng, s, r, n = _graph(1)
    m = 3
    if op == "masked_softmax":
        x = torch.from_numpy(rng.normal(size=(m, 4, 2, 6, 6)))
        mask = torch.from_numpy(rng.random((4, 6)) > 0.3)
        fn = lambda t: fsm.masked_softmax(t, mask)  # noqa: E731
    elif op == "spherical_jn":
        x = torch.from_numpy(rng.uniform(0.01, 5.0, size=(m, 7)))
        fn = lambda t: spherical_jn(3, t)  # noqa: E731
    else:
        x = torch.from_numpy(rng.normal(size=(m, 40, 3)))
        fn = {"segment_sum": lambda t: fs.fused_segment_sum(t, r, n),
              "gather_rows": lambda t: fs.gather_rows(t, s),
              "segment_softmax": lambda t: fsm.segment_softmax(t, r, n)}[op]
    x.requires_grad_(True)
    out = torch.func.vmap(fn)(x)
    g, = torch.autograd.grad((out * torch.arange(out.numel()).reshape(out.shape)).sum(), x)
    for i in range(m):
        xi = x.detach()[i].clone().requires_grad_(True)
        oi = fn(xi)
        gi, = torch.autograd.grad((oi * torch.arange(out.numel()).reshape(out.shape)[i]).sum(),
                                  xi)
        assert torch.equal(out[i], oi) and torch.equal(g[i], gi), i
    if op in ("segment_sum", "gather_rows", "segment_softmax"):
        ids = torch.stack([r] * m)
        call = {"segment_sum": lambda t, k: fs.fused_segment_sum(t, k, n),
                "gather_rows": lambda t, k: fs.gather_rows(t, k),
                "segment_softmax": lambda t, k: fsm.segment_softmax(t, k, n)}[op]
        with pytest.raises(ValueError, match="batched index input"):
            torch.func.vmap(call)(x.detach(), ids)


def test_member_exact_outside_vmap_is_the_plain_call():
    """``member_exact`` outside ``vmap`` calls the function itself (no
    Function node), and its Function's own backward, should it be applied,
    recomputes the gradient."""
    from hydragnn_tpu_torch.models.common import _PerMember, member_exact

    x = torch.randn(4, 3, requires_grad=True)
    w = torch.randn(2, 3, requires_grad=True)
    y = member_exact(torch.nn.functional.linear, x, w, None)
    assert y.grad_fn is not None and "PerMember" not in type(y.grad_fn).__name__
    z = _PerMember.apply(torch.nn.functional.linear, x, w, None)
    gz = torch.autograd.grad(z.sum(), (x, w))
    gy = torch.autograd.grad(y.sum(), (x, w))
    assert all(torch.equal(a, b) for a, b in zip(gy, gz))


# -- population plumbing ----------------------------------------------------------


def test_stack_member_checkpoint_and_template_round_trip(tmp_path):
    """A stacked population saves in the single state's files (the same
    ``state_dict`` keys, ``[N, ...]`` shapes), restores into a template,
    ``member_state`` slices a member out as a working single state, and
    ``stack_states`` stacks single states back, bit for bit."""
    from hydragnn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    s = setup("gin")
    hyper = {"learning_rates": [0.02, 0.005], "weight_decays": [1e-4, 0.01]}
    aug = copy.deepcopy(s.aug)
    pstate = P.create_population_state(aug, 2, seeds=[0, 1], device="cpu", **hyper)
    step = P.make_population_step()
    for b in s.batches[:2]:
        step(pstate, batch_from_numpy(b))
    assert set(pstate.model.state_dict()) == set(s.port_model().state_dict())
    save_checkpoint(pstate, "pop", 2, path=str(tmp_path), meta=P.population_meta(2, 2))
    template = P.population_template(aug, 2, device="cpu")
    meta = load_checkpoint(template, "pop", path=str(tmp_path))
    assert meta["population"] == 2 and template.step == pstate.step == 2
    assert template.hyperparams() == pstate.hyperparams()
    for i in range(2):
        _assert_member_equal(template, i, P.member_state(pstate, i), f"restored member {i}")
    members = [P.member_state(pstate, i) for i in range(2)]
    again = P.stack_states(members, aug["NeuralNetwork"]["Training"]["Optimizer"])
    b = batch_from_numpy(s.batches[2])
    m1, m2 = step(pstate, b), step(again, b)
    assert torch.equal(m1["loss"], m2["loss"])
    for x, y in zip(pstate.model.state_dict().values(), again.model.state_dict().values()):
        assert torch.equal(x, y)


def test_population_resume_through_training_continue_equals_uninterrupted(tmp_path):
    """``run_training`` with ``Training.population``: 2 epochs in one run,
    against 1 epoch and a ``Training.continue`` to 2 (the template, the
    sidecar's ``population_meta``, the epoch stream): the same stacked
    state, bit for bit, and ``population.json`` beside the checkpoints."""
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.config import get_log_name_config
    from hydragnn_tpu_torch.datasets import deterministic_graph_data

    cfg = single_head_config()
    cfg["NeuralNetwork"]["Training"].update(
        num_epoch=2, batch_size=16, population={"size": 2, "learning_rates": [0.02, 1e30]})
    samples = deterministic_graph_data(number_configurations=48, seed=3)
    full, _, aug = run_training(copy.deepcopy(cfg), samples=copy.deepcopy(samples),
                                device="cpu", path=str(tmp_path / "a"))
    half = copy.deepcopy(cfg)
    half["NeuralNetwork"]["Training"]["num_epoch"] = 1
    _, _, half_aug = run_training(half, samples=copy.deepcopy(samples), device="cpu",
                                  path=str(tmp_path / "b"))
    cont = copy.deepcopy(cfg)
    cont["NeuralNetwork"]["Training"].update(
        {"continue": 1, "startfrom": get_log_name_config(half_aug)})
    resumed, _, _ = run_training(cont, samples=copy.deepcopy(samples), device="cpu",
                                 path=str(tmp_path / "b"))
    assert resumed.step == full.step
    for x, y in zip(full.model.state_dict().values(), resumed.model.state_dict().values()):
        assert torch.equal(x, y)
    summary = json.load(open(os.path.join(tmp_path / "a", get_log_name_config(aug),
                                          "population.json")))
    assert [m["status"] for m in summary["members"]] == ["ok", "ok"]
    assert summary["members"][1]["objective"] == float("inf")
    assert summary["members"][1]["skipped_steps"] > 0
    assert summary["ensemble"]["n_finite"] == 1


def test_population_config_flags_and_refusals(monkeypatch):
    """The schema checks the per-member lists and fills a decay for
    per-member decays (as the JAX schema does); ``HYDRAGNN_POPULATION``
    wins over the size; dropout in a population is refused."""
    from hydragnn_tpu.config import update_config as jax_update_config
    from hydragnn_tpu.datasets import deterministic_graph_data as jax_data
    from hydragnn_tpu.train.population import resolve_population_size as jax_size
    from hydragnn_tpu_torch.config import update_config

    samples = jax_data(number_configurations=12, seed=1)
    cfg = single_head_config()
    cfg["NeuralNetwork"]["Training"]["population"] = {"size": 2, "weight_decays": [0.1, 0.2]}
    ours = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
    theirs = jax_update_config(copy.deepcopy(cfg), tpu.jax_samples_copy(samples))
    for key in ("population", "Optimizer", "steps_per_dispatch"):
        assert ours["NeuralNetwork"]["Training"][key] == theirs["NeuralNetwork"]["Training"][key]
    assert ours["Screening"] == theirs["Screening"]
    bad = copy.deepcopy(cfg)
    bad["NeuralNetwork"]["Training"]["population"]["seeds"] = [1, 2, 3]
    with pytest.raises(ValueError, match="seeds has 3 entries"):
        update_config(bad, tpu.port_samples(samples))
    training = {"population": {"size": 3}}
    monkeypatch.setenv("HYDRAGNN_POPULATION", "5")
    assert P.resolve_population_size(training) == jax_size(training) == 5
    monkeypatch.delenv("HYDRAGNN_POPULATION")
    assert P.resolve_population_size(training) == jax_size(training) == 3
    gat = copy.deepcopy(setup("gat").aug)
    gat["NeuralNetwork"]["Architecture"]["dropout"] = 0.25
    with pytest.raises(ValueError, match="dropout"):
        P.create_population_state(gat, 2, device="cpu")


def test_member_tracker_and_accumulate_match_jax():
    """``MemberTracker``'s lagged streaks and ``accumulate_members``'s
    weighted means (NaN for a member that trained nothing) equal the JAX
    package's on the same streams."""
    from hydragnn_tpu.train.population import MemberTracker as JaxTracker
    from hydragnn_tpu.train.population import accumulate_members as jax_acc

    rng = np.random.default_rng(0)
    stream = (rng.random((40, 3)) < [0.0, 0.3, 0.9]).astype(np.int32)
    ours, theirs = P.MemberTracker(3, 4, lag=5), JaxTracker(3, 4, lag=5)
    for row in stream:
        ours.push(torch.from_numpy(row))
        theirs.push(row)
    assert ours.state_dict() == theirs.state_dict()
    assert ours.statuses() == theirs.statuses()
    metrics = [{"loss": rng.random(3), "tasks_loss": rng.random((3, 2)),
                "num_graphs": np.array([4.0, 0.0, 2.0]), "head_sse": rng.random((3, 2))}
               for _ in range(5)]
    got = P.accumulate_members([{k: torch.from_numpy(v) for k, v in m.items()} for m in metrics],
                               ("head_sse",), n_members=3)
    want = jax_acc(metrics, ("head_sse",), n_members=3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    np.testing.assert_allclose(got[2]["head_sse"], want[2]["head_sse"], rtol=1e-12)
    assert np.isnan(got[0][1])
