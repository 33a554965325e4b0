"""Shared cases of the ``tests/test_torch_edge_sharded_*.py`` modules (not a
test module): each of the port's stacks at CI size (hidden 8, 2 conv
layers, one batch of four 400-atom graphs, as ``test_torch_large_graph.py``)
through the port's edge-sharded route on two ``gloo`` ranks
(``torch_parallel_pool.py``), held against the JAX package's edge-sharded
steps on a 2-device mesh and against the port's own one-device steps.

:func:`check_stack` holds, on every rank: the outputs of
``make_edge_sharded_apply``, the eval metrics of
``make_edge_sharded_eval_step``, the loss of one SGD step (lr 0.1) through
``make_edge_sharded_train_step``, every gradient (against the one-device
step's) and every parameter after the step (against both); and the ranks'
parameters bit-equal after the step. Tolerances are the module's (rtol
1e-5 / atol 1e-6 unless a case states its reason for more).
"""

from __future__ import annotations

import copy

import numpy as np

import torch_port_util as tpu
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.graphs.batching import collate, compute_pad_spec
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models import init_model
from hydragnn_tpu.preprocess import apply_variables_of_interest
from hydragnn_tpu_torch.graphs.graph import FIELDS
from test_config import CI_CONFIG
from test_halo import giant_sample
from test_torch_large_graph import SGD, _jax_edge_sharded, _port_single
from test_training_e2e import ARCH_OVERRIDES

TOL = dict(rtol=1e-5, atol=1e-6)

# each stack's CI architecture: the canaries' overrides, with the
# coordinate updates on where a stack has them (SchNet, EGNN)
STACK_ARCH = {stack: dict(ARCH_OVERRIDES.get(stack, {}), mpnn_type=stack)
              for stack in ("GIN", "SAGE", "MFC", "GAT", "PNA", "PNAPlus", "CGCNN", "SchNet",
                            "EGNN", "PAINN", "PNAEq", "MACE", "DimeNet")}
STACK_ARCH["SchNet"]["equivariance"] = True
STACK_ARCH["EGNN"]["equivariance"] = True
# the JAX package's dropout masks are not the port's: GAT's attention
# dropout is held against the port's one-device step alone
STACK_ARCH["GAT"]["dropout"] = 0.0


def case(stack: str, gps: str | None = None, n_atoms: int = 400, box: float = 12.0,
         training: dict | None = None, pad=None, **arch):
    """(JAX model, JAX batch of four graphs, port config, flax variables
    jittered) of ``stack`` (with ``gps``: GPS around it, ``"multihead"`` or
    ``"ring"``; ``training``: Training keys; ``pad``: maps the batch's
    ``PadSpec`` to the one it is collated at; ``arch``: more architecture
    keys)."""
    from hydragnn_tpu.graphs.triplets import attach_triplets
    from hydragnn_tpu.preprocess.encodings import attach_lap_pe
    from hydragnn_tpu_torch.config import update_config

    cfg = copy.deepcopy(CI_CONFIG)
    a = cfg["NeuralNetwork"]["Architecture"]
    a["radius"] = 2.5
    a.update(STACK_ARCH[stack])
    a.update(arch)
    cfg["NeuralNetwork"]["Training"].update(training or {})
    if gps:
        a.update(global_attn_engine="GPS", global_attn_type=gps, global_attn_heads=2,
                 pe_dim=2, dropout=a.get("dropout", 0.0))
    samples = []
    for i in range(4):
        s = giant_sample(n_atoms, seed=20 + i, box=box)
        s.x = np.ascontiguousarray(s.x[:, :1])
        if gps:
            attach_lap_pe(s, 2)
        if stack == "DimeNet":
            attach_triplets(s)
        samples.append(s)
    samples = apply_variables_of_interest(samples, cfg)
    jaug = jax_update_config(copy.deepcopy(cfg), samples)
    aug = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
    jmodel = jax_create_model_config(jaug)
    spec = compute_pad_spec(samples, len(samples))
    batch = collate(samples, pad(spec) if pad else spec)
    variables = dict(init_model(jmodel, batch))
    variables.setdefault("batch_stats", {})  # the stacks without a feature norm
    variables = tpu.random_batch_stats(tpu.jitter_params(variables, seed=1), seed=2)
    return jmodel, batch, aug, variables


def batch_arrays(batch) -> dict:
    return {f: np.asarray(getattr(batch, f)) for f in FIELDS}


def run_ranks(pool, aug, variables, batch, **extra) -> list:
    """The port's edge-sharded apply, eval and train step on every rank."""
    port = tpu.port_model_from_jax(aug, variables)
    return pool.run("edge", {"aug": aug, "opt": SGD,
                             "state": {k: v.numpy() for k, v in port.state_dict().items()},
                             "batch": batch_arrays(batch), **extra})


def _close(got, want, tol: dict, scaled: float, err_msg: str) -> None:
    """``assert_allclose`` at ``tol``, its atol raised to ``scaled`` times the
    largest |want| of the tensor where ``scaled`` is set."""
    atol = max(tol["atol"], scaled * float(np.abs(want).max())) if scaled and np.size(want) \
        else tol["atol"]
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol, err_msg=err_msg)


def port_single_seeded(aug, variables, batch) -> tuple[dict, dict]:
    """The port's one-device SGD step from the train state the ranks make
    (``create_train_state(..., seed=0)``: its generator draws the dropout
    masks): the metrics and the gradients."""
    from hydragnn_tpu_torch.convert import batch_from_numpy
    from hydragnn_tpu_torch.train.step import create_train_state, make_train_step

    port = tpu.port_model_from_jax(aug, variables)
    state = create_train_state(port, SGD, seed=0)
    m = {k: v.detach().numpy() for k, v in make_train_step()(state, batch_from_numpy(batch)).items()}
    return m, {n: p.grad.numpy().copy() for n, p in port.named_parameters()}


def check_stack(pool, stack: str, tol: dict = TOL, gps: str | None = None, jax: bool = True,
                scaled: float = 0.0, jax_scaled: float | None = None, pad=None,
                **arch) -> None:
    """The edge-sharded route of ``stack`` on the pool's ranks against the
    JAX package's (``jax``) and the port's one-device steps; ``scaled``
    (``jax_scaled`` against the JAX package, ``scaled`` when None): each
    tensor's atol at least that share of its largest entry; ``pad`` as
    :func:`case`'s."""
    jmodel, batch, aug, variables = case(stack, gps, pad=pad, **arch)
    outs = run_ranks(pool, aug, variables, batch)
    sout, sev, sm, sgrads, sstate = _port_single(aug, variables, batch)
    refs = [("one device", scaled, sout, sev, sm, sstate)]
    if jax:
        jout, jev, jm, jparams = _jax_edge_sharded(jmodel, batch, variables,
                                                   ring=gps == "ring")
        refs.append(("JAX", scaled if jax_scaled is None else jax_scaled, jout, jev, jm,
                     jparams))
    gm = np.asarray(batch.graph_mask) > 0
    for r, out in enumerate(outs):
        for what, sc, ref_out, ref_ev, ref_m, ref_params in refs:
            for g, w in zip(out["outputs"], ref_out):
                _close(g[gm], w[gm], tol, sc, f"{stack} rank {r} outputs vs {what}")
            for k in ("loss", "tasks_loss", "head_sse", "head_count"):
                _close(out["eval"][k], ref_ev[k], tol, sc, f"{stack} rank {r} eval {k} vs {what}")
            _close(out["step"]["loss"], ref_m["loss"], tol, sc, f"{stack} rank {r} loss vs {what}")
            for name, w in ref_params.items():
                _close(out["state"][name], w, tol, sc, f"{stack} rank {r} {name} vs {what}")
        for name, w in sgrads.items():
            _close(out["grads"][name], w, tol, scaled, f"{stack} rank {r} gradient {name}")
    for name in outs[0]["state"]:
        np.testing.assert_array_equal(outs[0]["state"][name], outs[1]["state"][name],
                                      err_msg=f"{stack}: the ranks' {name} differ")
