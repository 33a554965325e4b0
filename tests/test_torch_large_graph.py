"""The port's edge-sharded route (``hydragnn_tpu_torch/parallel/
large_graph.py``, ``models/common.py``'s ``edge_sharded``) on two ``gloo`` ranks against the
JAX package's edge-sharded steps on a 2-device mesh and against the port's
own one-device steps: the CI GIN (hidden 8, 2 layers) on one batch of four
400-atom graphs, and GPS-GIN with ``ring`` attention, whose node rows the
same two ranks split (the JAX package's ring over its published mesh).

Tolerances, with their reasons (fp32 throughout):

* outputs, eval losses and squared errors: rtol 1e-5 / atol 1e-6; each
  node's neighbour sum adds two partial sums where one device adds one run;
* gradients and parameters after one SGD step (lr 0.1): rtol 1e-5 / atol
  1e-6 (GPS: atol 1e-5, the ring's online softmax rescales its partial
  sums hop by hop where the flat softmax normalises once).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.graphs.batching import collate, compute_pad_spec
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models import init_model
from hydragnn_tpu.parallel import large_graph as jlg
from hydragnn_tpu.parallel import make_mesh, shard_state
from hydragnn_tpu.preprocess import apply_variables_of_interest
from hydragnn_tpu.train import create_train_state, select_optimizer
from hydragnn_tpu_torch.convert import batch_from_numpy, port_arrays
from hydragnn_tpu_torch.graphs.graph import FIELDS
from test_config import CI_CONFIG
from test_halo import giant_sample
from torch_parallel_pool import WorkerPool

TOL = dict(rtol=1e-5, atol=1e-6)
GPS_TOL = dict(rtol=1e-5, atol=1e-5)
SGD = {"type": "SGD", "learning_rate": 0.1}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = WorkerPool(tmp_path_factory.mktemp("large_graph"))
    yield p
    p.close()


def _case(gps: bool = False):
    """(JAX model, JAX batch of four graphs, port config, variables)."""
    from hydragnn_tpu.preprocess.encodings import attach_lap_pe
    from hydragnn_tpu_torch.config import update_config

    cfg = copy.deepcopy(CI_CONFIG)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch["radius"] = 2.5
    if gps:
        arch.update(global_attn_engine="GPS", global_attn_type="ring", global_attn_heads=2,
                    pe_dim=2, dropout=0.0)
    samples = []
    for i in range(4):
        s = giant_sample(100 if gps else 400, seed=20 + i, box=8.0 if gps else 12.0)
        s.x = np.ascontiguousarray(s.x[:, :1])
        if gps:
            attach_lap_pe(s, 2)
        samples.append(s)
    samples = apply_variables_of_interest(samples, cfg)
    jaug = jax_update_config(copy.deepcopy(cfg), samples)
    aug = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
    jmodel = jax_create_model_config(jaug)
    batch = collate(samples, compute_pad_spec(samples, len(samples)))
    variables = tpu.random_batch_stats(tpu.jitter_params(init_model(jmodel, batch), seed=1),
                                       seed=2)
    return jmodel, batch, aug, variables


def _jax_edge_sharded(jmodel, batch, variables, ring: bool):
    from hydragnn_tpu.parallel.ring_attention import set_global_mesh

    mesh = make_mesh(devices=jax.devices()[:2])
    opt = select_optimizer(SGD)
    set_global_mesh(mesh if ring else None)
    try:
        state = create_train_state(jmodel, opt, jax.tree.map(jnp.asarray, batch))
        state = state._replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                               batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
        state = shard_state(state, mesh)
        lb = jlg.put_large_batch(batch, mesh)
        out = jlg.make_edge_sharded_apply(jmodel, mesh)(variables, lb)
        ev = jlg.make_edge_sharded_eval_step(jmodel, mesh)(state, lb)
        new, m = jlg.make_edge_sharded_train_step(jmodel, opt, mesh)(state, lb)
    finally:
        set_global_mesh(None)
    return ([np.asarray(o) for o in out], {k: np.asarray(v) for k, v in ev.items()},
            {k: np.asarray(v) for k, v in m.items()}, port_arrays(tpu.numpy_tree(new.params)))


def _port_single(aug, variables, batch):
    """The port's one-device predict, eval and SGD step, and the gradients."""
    from hydragnn_tpu_torch.train.optimizer import select_optimizer as port_opt
    from hydragnn_tpu_torch.train.step import (TrainState, make_eval_step,
                                               make_predict_step, make_train_step)

    port = tpu.port_model_from_jax(aug, variables)
    state = TrainState(port, port_opt(SGD, port.parameters()))
    out = [o.numpy() for o in make_predict_step(port)(batch_from_numpy(batch))]
    ev = {k: v.detach().numpy() for k, v in make_eval_step()(state, batch_from_numpy(batch)).items()}
    m = {k: v.detach().numpy() for k, v in make_train_step()(state, batch_from_numpy(batch)).items()}
    grads = {n: p.grad.numpy().copy() for n, p in port.named_parameters()}
    return out, ev, m, grads, {k: v.detach().numpy() for k, v in port.state_dict().items()}


@pytest.mark.parametrize("gps", [False, True], ids=["gin", "gps_gin_ring"])
def test_edge_sharded_steps_match_jax_and_the_one_device_step(pool, gps):
    jmodel, batch, aug, variables = _case(gps)
    tol = GPS_TOL if gps else TOL
    port = tpu.port_model_from_jax(aug, variables)
    outs = pool.run("edge", {"aug": aug, "opt": SGD,
                             "state": {k: v.numpy() for k, v in port.state_dict().items()},
                             "batch": {f: np.asarray(getattr(batch, f)) for f in FIELDS}})
    jout, jev, jm, jparams = _jax_edge_sharded(jmodel, batch, variables, ring=gps)
    sout, sev, sm, sgrads, sstate = _port_single(aug, variables, batch)
    n_edges = np.asarray(batch.senders).shape[0]
    gm = np.asarray(batch.graph_mask) > 0
    for r, out in enumerate(outs):
        assert out["n_edges"] == -(-n_edges // 2)  # this rank's half of the edges
        for g, w, s in zip(out["outputs"], jout, sout):
            np.testing.assert_allclose(g[gm], w[gm], **tol, err_msg=f"rank {r} outputs")
            np.testing.assert_allclose(g[gm], s[gm], **tol, err_msg="one device outputs")
        for k in ("loss", "tasks_loss", "head_sse", "head_count"):
            np.testing.assert_allclose(out["eval"][k], jev[k], **tol, err_msg=k)
            np.testing.assert_allclose(out["eval"][k], sev[k], **tol, err_msg=k)
        np.testing.assert_allclose(out["step"]["loss"], jm["loss"], **tol)
        np.testing.assert_allclose(out["step"]["loss"], sm["loss"], **tol)
        for name, w in jparams.items():
            np.testing.assert_allclose(out["state"][name], w, **tol, err_msg=name)
            np.testing.assert_allclose(out["state"][name], sstate[name], **tol, err_msg=name)
            np.testing.assert_allclose(out["grads"][name], sgrads[name], **tol,
                                       err_msg=f"gradient {name}")
    for name in outs[0]["state"]:
        np.testing.assert_array_equal(outs[0]["state"][name], outs[1]["state"][name])


def test_sharded_segment_sum_and_conv_step_match_jax(pool):
    """The JAX package's primitives, an edge-sharded scatter-add and one
    GIN-style layer over two ranks' edge halves on the mesh, against the
    port's edge-sharded neighbour sum (``neighbour_sum`` under
    ``edge_sharded``, the route's one edge reduction) on the two ranks."""
    from hydragnn_tpu.parallel.edge_sharding import edge_sharded_conv_step, sharded_segment_sum

    rng = np.random.default_rng(0)
    n, e, f = 20, 64, 6
    inp = {"h": rng.normal(size=(n, f)).astype(np.float32),
           "msg": rng.normal(size=(e, f)).astype(np.float32),
           "snd": rng.integers(0, n, e).astype(np.int32),
           "rcv": rng.integers(0, n, e).astype(np.int32),
           "mask": (rng.random(e) > 0.2).astype(np.float32),
           "w": rng.normal(size=(f, f)).astype(np.float32)}
    outs = pool.run("edge_primitives", inp)
    mesh = make_mesh(devices=jax.devices()[:2])
    seg = np.asarray(sharded_segment_sum(mesh, jnp.asarray(inp["msg"]), jnp.asarray(inp["rcv"]),
                                         n))
    conv = np.asarray(edge_sharded_conv_step(mesh, *(jnp.asarray(inp[k]) for k in
                                                     ("h", "snd", "rcv", "mask", "w"))))
    for out in outs:
        np.testing.assert_allclose(out["segment_sum"], seg, **TOL)
        np.testing.assert_allclose(out["conv"], conv, **TOL)
    # the gradient of a replicated input is whole on every rank
    np.testing.assert_array_equal(outs[0]["dh"], outs[1]["dh"])
    h = torch.tensor(inp["h"], requires_grad=True)
    msg = h[torch.tensor(inp["snd"]).long()] * torch.tensor(inp["mask"])[:, None]
    ref = torch.zeros(n, f).index_add(0, torch.tensor(inp["rcv"]).long(),
                                      msg @ torch.tensor(inp["w"]))
    ref.sum().backward()
    np.testing.assert_allclose(outs[0]["dh"], h.grad.numpy(), **TOL)


@pytest.mark.parametrize("world", [1, 3])
def test_edge_share_splits_the_edges_contiguously(world):
    """``edge_share``: every rank keeps every node and graph field; the
    ranks' edge blocks, in rank order, are the batch's edges padded to a
    multiple of the ranks with masked edges on the padding node."""
    from hydragnn_tpu_torch.parallel.large_graph import _EDGE_FIELDS, edge_share

    _, jbatch, _, _ = _case()
    batch = batch_from_numpy(jbatch)
    shares = [edge_share(batch, world, r) for r in range(world)]
    e = batch.num_edges
    pad = -e % world
    n = batch.num_nodes
    for f in FIELDS:
        whole = getattr(batch, f).numpy()
        parts = [getattr(sh, f).numpy() for sh in shares]
        if f in _EDGE_FIELDS and whole.shape[0]:
            got = np.concatenate(parts)
            assert got.shape[0] == e + pad and all(p.shape[0] == got.shape[0] // world
                                                   for p in parts), f
            np.testing.assert_array_equal(got[:e], whole, err_msg=f)
            want_pad = n - 1 if f in ("senders", "receivers") else 0
            assert (got[e:] == want_pad).all(), f
        else:
            for p in parts:
                np.testing.assert_array_equal(p, whole, err_msg=f)


def test_edge_sharding_refusals():
    """Every stack runs edge-sharded now (SAGE among them); what stays
    refused: SyncBatchNorm (the JAX package's ValueError), the interatomic
    potential (the JAX package's edge-sharded step has no force term) and
    ``edge_sharding: "full"`` (the next parallelism slice)."""
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.parallel import large_graph as lg
    from hydragnn_tpu_torch.run_training import _parallel_request

    _, _, aug, _ = _case()
    for override, error, what in (({"SyncBatchNorm": True}, ValueError, "SyncBatchNorm"),
                                  ({"mpnn_type": "SAGE"}, None, None),
                                  ({"enable_interatomic_potential": True}, NotImplementedError,
                                   "no force term")):
        cfg = copy.deepcopy(aug)
        cfg["NeuralNetwork"]["Architecture"].update(override)
        model = create_model_config(cfg, device="cpu")
        if error is None:
            lg.make_edge_sharded_train_step(model)
            continue
        with pytest.raises(error, match=what):
            lg.make_edge_sharded_train_step(model)
    cfg = copy.deepcopy(aug)
    cfg["NeuralNetwork"]["Architecture"]["edge_sharding"] = "full"
    with pytest.raises(NotImplementedError, match="next parallelism slice"):
        _parallel_request(cfg)
