"""The port's halo route (``hydragnn_tpu_torch/parallel/halo.py``) on two
``gloo`` ranks against the JAX package's halo steps on a 2-device mesh, and
against the port's own one-device steps on the whole graph: one giant
300-atom graph (``tests/test_halo.py``'s), the CI GIN (hidden 8, 2 layers)
and GAT, graph and node heads.

Tolerances, with their reasons (fp32 throughout):

* eval losses, squared errors and outputs: rtol 1e-5 / atol 1e-6; the
  ranks' partial sums (pooling, norms, losses) add in another order than
  one device's or XLA's;
* parameters after one SGD step (lr 0.1): rtol 1e-5 / atol 1e-6, the
  gradient's rounding at 1e-5 of a step;
* against the one-device step the same: the Morton order of the nodes
  changes only the order of sums.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_util as tpu
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.graphs.batching import collate, compute_pad_spec
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models import init_model
from hydragnn_tpu.parallel import make_mesh, shard_state
from hydragnn_tpu.parallel import halo as jhalo
from hydragnn_tpu.preprocess import apply_variables_of_interest
from hydragnn_tpu.train import create_train_state, select_optimizer
from hydragnn_tpu_torch.convert import batch_from_numpy, port_arrays
from hydragnn_tpu_torch.graphs.graph import FIELDS
from test_config import CI_CONFIG
from test_halo import giant_sample
from torch_parallel_pool import WorkerPool

TOL = dict(rtol=1e-5, atol=1e-6)
SGD = {"type": "SGD", "learning_rate": 0.1}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = WorkerPool(tmp_path_factory.mktemp("halo"))
    yield p
    p.close()


def _case(mpnn="GIN", node_head=False, n=300):
    """(JAX model, JAX batch, port config, JAX variables, port model)."""
    from hydragnn_tpu_torch.config import update_config

    cfg = copy.deepcopy(CI_CONFIG)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(radius=2.5, mpnn_type=mpnn)
    if mpnn == "GAT":
        arch.update(heads=2, dropout=0.0)
    if node_head:
        arch["output_heads"] = {"node": {"num_headlayers": 2, "dim_headlayers": [8, 8],
                                         "type": "mlp"}}
        cfg["NeuralNetwork"]["Variables_of_interest"] = {
            "input_node_features": [0], "output_index": [0], "type": ["node"],
            "output_dim": [1], "denormalize_output": False}
    sample = giant_sample(n, seed=7)
    sample.x = np.ascontiguousarray(sample.x[:, :1])  # the one input feature the CI GIN reads
    samples = apply_variables_of_interest([sample], cfg)
    jaug = jax_update_config(copy.deepcopy(cfg), samples)
    aug = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
    jmodel = jax_create_model_config(jaug)
    batch = collate(samples[:1], compute_pad_spec(samples, 1))
    variables = tpu.random_batch_stats(tpu.jitter_params(init_model(jmodel, batch), seed=1),
                                       seed=2)
    return jmodel, batch, aug, variables, tpu.port_model_from_jax(aug, variables)


def _jax_halo(jmodel, batch, variables):
    mesh = make_mesh(n_data=2, n_branch=1, devices=jax.devices()[:2])
    opt = select_optimizer(SGD)
    dev = jax.tree.map(jnp.asarray, batch)
    state = create_train_state(jmodel, opt, dev)
    state = state._replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    state = shard_state(state, mesh)
    hb = jhalo.put_halo_batch(batch, mesh, cutoff=2.5)
    ev = jhalo.make_halo_eval_step(jmodel, mesh)(state, hb)
    out = jhalo.make_halo_apply(jmodel, mesh)(variables, hb)
    new, m = jhalo.make_halo_train_step(jmodel, opt, mesh)(state, hb)
    return ({k: np.asarray(v) for k, v in ev.items()}, [np.asarray(o) for o in out], hb,
            {k: np.asarray(v) for k, v in m.items()}, port_arrays(tpu.numpy_tree(new.params)))


def _port_single(port, batch):
    """The port's one-device eval and SGD train step on the whole graph."""
    from hydragnn_tpu_torch.train.optimizer import select_optimizer as port_opt
    from hydragnn_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

    state = TrainState(port, port_opt(SGD, port.parameters()))
    ev = make_eval_step()(state, batch_from_numpy(batch))
    m = make_train_step()(state, batch_from_numpy(batch))
    return ({k: v.detach().numpy() for k, v in ev.items()},
            {k: v.detach().numpy() for k, v in m.items()},
            {k: v.detach().numpy() for k, v in port.state_dict().items()})


@pytest.mark.parametrize("mpnn,node_head", [("GIN", False), ("GIN", True), ("GAT", False)],
                         ids=["gin_graph_head", "gin_node_head", "gat_graph_head"])
def test_halo_steps_match_jax_and_the_one_device_step(pool, mpnn, node_head):
    jmodel, batch, aug, variables, port = _case(mpnn, node_head)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    outs = pool.run("halo", {"aug": aug, "opt": SGD, "state": state, "cutoff": 2.5,
                             "batch": {f: np.asarray(getattr(batch, f)) for f in FIELDS}})
    jev, jout, jhb, jm, jparams = _jax_halo(jmodel, batch, variables)
    sev, sm, sstate = _port_single(tpu.port_model_from_jax(aug, variables), batch)
    kind = aug["NeuralNetwork"]["Variables_of_interest"]["type"][0]
    for r, out in enumerate(outs):
        for k in ("loss", "tasks_loss", "head_sse", "head_count"):
            np.testing.assert_allclose(out["eval"][k], jev[k], **TOL, err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(out["eval"][k], sev[k], **TOL, err_msg=f"one device {k}")
        np.testing.assert_allclose(out["step"]["loss"], jm["loss"], **TOL)
        np.testing.assert_allclose(out["step"]["loss"], sm["loss"], **TOL)
        for name, w in jparams.items():
            np.testing.assert_allclose(out["state"][name], w, **TOL, err_msg=f"rank {r} {name}")
            np.testing.assert_allclose(out["state"][name], sstate[name], **TOL,
                                       err_msg=f"one device {name}")
    for name in outs[0]["state"]:
        np.testing.assert_array_equal(outs[0]["state"][name], outs[1]["state"][name])
    if kind == "graph":
        for out in outs:
            np.testing.assert_allclose(out["outputs"][0][:1], jout[0][:1], **TOL)
    else:
        frame = jhalo.HaloBatch(batch=None, plan=None, node_global=outs[0]["node_global"],
                                n_owned=outs[0]["n_owned"])
        got = jhalo.gather_node_predictions(np.stack([o["outputs"][0] for o in outs]), frame)
        want = jhalo.gather_node_predictions(jout[0], jhb)
        np.testing.assert_allclose(got, want, **TOL)
    # the halo rows on the wire below the replicated all-reduce's
    assert 0 < outs[0]["halo_bytes"] < jhalo.replicated_allreduce_bytes(
        300, aug["NeuralNetwork"]["Architecture"]["hidden_dim"], 2)


def test_halo_refresh_sends_cotangents_back_to_their_owners(pool):
    """The refresh and its backward on two ranks, against the plan computed
    here: the halo slots hold their owners' rows; the gradient of ``sum(out
    * w)`` is ``w`` on the owned rows plus, sent back and added, ``w`` of
    every halo slot that copies them, and 0 on the overwritten slots."""
    from hydragnn_tpu_torch.parallel.halo import partition_graph_batch

    _, batch, _, _, _ = _case()
    arrays = {f: np.asarray(getattr(batch, f)) for f in FIELDS}
    hb = partition_graph_batch(arrays, 2, cutoff=2.5)
    n_loc = hb.node_global.shape[1]
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, n_loc, 5)).astype(np.float32)
    w = rng.normal(size=(2, n_loc, 5)).astype(np.float32)
    outs = pool.run("refresh", {"batch": arrays, "cutoff": 2.5, "h": h, "w": w})
    out, grad = h.copy(), w.copy()
    for i, (send, recv) in enumerate(zip(hb.plan.send_idx, hb.plan.recv_slot)):
        for d in range(2):
            src = (d - (i + 1)) % 2
            out[d][recv[d]] = out[src][send[src]]
    for i in reversed(range(len(hb.plan.send_idx))):
        send, recv = hb.plan.send_idx[i], hb.plan.recv_slot[i]
        back = [grad[d][recv[d]].copy() for d in range(2)]
        for d in range(2):
            grad[d][recv[d]] = 0
        for d in range(2):
            np.add.at(grad[(d - (i + 1)) % 2], send[(d - (i + 1)) % 2], back[d])
    assert sum(int(s.shape[1]) for s in hb.plan.send_idx) > 0
    for d, o in enumerate(outs):
        np.testing.assert_array_equal(o["out"][:-1], out[d][:-1])  # the trash slot aside
        np.testing.assert_allclose(o["grad"], grad[d], rtol=1e-6, atol=1e-6)
