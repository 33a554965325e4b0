"""The port's GPS global attention (``hydragnn_tpu_torch.models.gps``) and
its preprocessing against the JAX package's, on the CPU: Laplacian
positional encodings, the derived dense-attention width
(``max_graph_nodes``), collate's per-graph node certificate with a user cap
(``attn_cap``), the GPS-GIN forward and gradients from the same parameters
(the JAX model's, converted), the dense-block path against the exact flat
path, a short ``run_training``, and the server refusing a request without
positional encodings at admission.

The model is the tier-1 GPS-GIN (``tests/test_gps.py``: ``CI_CONFIG``,
hidden 8, 2 conv layers, 2 attention heads, ``pe_dim`` 2) with ``dropout``
0, under which both packages compute the same function.

Tolerances: fp32 at rtol 1e-4 / atol 1e-5, XLA and PyTorch summing in other
orders through the local conv, the attention products, three batch norms
per layer and the heads. The bf16 predict step runs conv layer 0 (its
local conv and its attention) in bf16 on both sides, where the two may
round to neighbouring bf16 values: rtol / atol 3e-2.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.graphs.batching import collate as jax_collate
from hydragnn_tpu.graphs.batching import compute_pad_spec as jax_compute_pad_spec
from hydragnn_tpu.preprocess.encodings import laplacian_pe as jax_laplacian_pe
from hydragnn_tpu.train.step import TrainState as JaxTrainState
from hydragnn_tpu.train.step import make_predict_step as jax_make_predict_step
from hydragnn_tpu_torch.convert import batch_from_numpy
from hydragnn_tpu_torch.graphs.batching import collate, compute_pad_spec
from hydragnn_tpu_torch.preprocess.encodings import attach_lap_pe, laplacian_pe
from hydragnn_tpu_torch.train.step import make_predict_step
from test_config import CI_CONFIG
from test_torch_train_step import Setup, _jax_grads, _port_grads

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def gps_config(dropout: float = 0.0) -> dict:
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Architecture"].update(
        global_attn_engine="GPS", global_attn_heads=2, pe_dim=2, dropout=dropout)
    return cfg


@pytest.fixture(scope="module")
def setup():
    s = Setup(gps_config())
    arch = s.jaug["NeuralNetwork"]["Architecture"]
    assert arch["max_graph_nodes"] and s.batches[0].pe.shape[1] == 2
    return s


# -- preprocessing -------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_laplacian_pe_matches_jax(k):
    samples = deterministic_graph_data(number_configurations=6, seed=3)
    for s in samples:
        got = laplacian_pe(s.senders, s.receivers, s.num_nodes, k)
        want = jax_laplacian_pe(s.senders, s.receivers, s.num_nodes, k)
        assert got.dtype == np.float32 and got.shape == (s.num_nodes, k)
        np.testing.assert_array_equal(got, want)
    # fewer nodes than k + 1: zero-padded columns
    tiny = laplacian_pe(np.array([0, 1]), np.array([1, 0]), 2, 4)
    np.testing.assert_array_equal(tiny, jax_laplacian_pe(np.array([0, 1]), np.array([1, 0]),
                                                         2, 4))
    assert (tiny[:, 1:] == 0).all()


def test_attach_lap_pe_sets_relative_encodings():
    (s,) = tpu.port_samples(deterministic_graph_data(number_configurations=1, seed=4))
    attach_lap_pe(s, 3)
    pe = s.extras["pe"]
    np.testing.assert_array_equal(s.extras["rel_pe"],
                                  np.abs(pe[s.senders] - pe[s.receivers]))
    assert attach_lap_pe(s, 3) is s and s.extras["pe"] is pe  # idempotent


@pytest.mark.parametrize("user_cap", [None, 16, 64])
def test_max_graph_nodes_and_gps_defaults_match_jax(user_cap):
    """``update_config`` fills the GPS keys and derives the 8-aligned
    dense-attention width from the largest training graph, or keeps the
    user's."""
    from hydragnn_tpu_torch.config import update_config

    cfg = gps_config()
    if user_cap:
        cfg["NeuralNetwork"]["Architecture"]["max_graph_nodes"] = user_cap
    samples = deterministic_graph_data(number_configurations=20, seed=5)
    want = jax_update_config(copy.deepcopy(cfg), samples)["NeuralNetwork"]["Architecture"]
    got = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
    got = got["NeuralNetwork"]["Architecture"]
    for key in ("global_attn_engine", "global_attn_type", "global_attn_heads", "pe_dim",
                "max_graph_nodes"):
        assert got[key] == want[key], key
    assert got["max_graph_nodes"] % 8 == 0 or user_cap
    plain = update_config(copy.deepcopy(CI_CONFIG), tpu.port_samples(samples))
    assert plain["NeuralNetwork"]["Architecture"]["max_graph_nodes"] is None


def _sized_samples(sizes, seed=0):
    from hydragnn_tpu.graphs.graph import GraphSample

    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        s = np.arange(n - 1, dtype=np.int32)
        out.append(GraphSample(x=rng.normal(size=(n, 1)), senders=s, receivers=s + 1,
                               graph_y=np.zeros(1)))
    return out


@pytest.mark.parametrize("attn_cap", [0, 12, 40])
@pytest.mark.parametrize("batch_sizes", [(5, 9, 11), (5, 9, 20), (3, 4)],
                         ids=["fits_cap", "outlier", "small"])
def test_attn_cap_certification_matches_jax(attn_cap, batch_sizes):
    """Collate's per-graph node bound: the user's cap when it is below the
    dataset max and the batch honours it, else the dataset max when the
    batch honours that, else a power of two."""
    dataset = _sized_samples((5, 9, 11, 20, 30, 3, 4))
    jpad = jax_compute_pad_spec(dataset, 4, attn_cap=attn_cap)
    ppad = compute_pad_spec(tpu.port_samples(dataset), 4, attn_cap=attn_cap)
    assert (ppad.as_tuple(), ppad.node_cap, ppad.attn_cap) == \
        (jpad.as_tuple(), jpad.node_cap, jpad.attn_cap)
    chunk = _sized_samples(batch_sizes, seed=1)
    want = jax_collate(chunk, jpad).meta.max_n_node
    assert collate(tpu.port_samples(chunk), ppad).meta.max_n_node == want


def test_pipeline_attaches_pe_and_certifies_at_the_user_cap():
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = gps_config()
    cfg["NeuralNetwork"]["Architecture"]["max_graph_nodes"] = 8
    samples = tpu.port_samples(deterministic_graph_data(number_configurations=30, seed=6))
    loaders = dataset_loading_and_splitting(cfg, samples=samples)
    assert all(s.extras["pe"].shape[1] == 2 and "rel_pe" in s.extras
               for ld in loaders for s in ld.samples)
    assert loaders[0].pad.attn_cap == 8
    batch = next(iter(loaders[0]))
    assert batch.pe.shape == (batch.num_nodes, 2)


# -- the model -------------------------------------------------------------------


def _real_rows(outputs, batch):
    gm = np.asarray(batch.graph_mask) > 0
    return [np.asarray(o, np.float32)[gm] for o in outputs]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_gps_forward_matches_jax(setup, precision):
    """The predict step through the dense-block path (collate certifies the
    batch within ``max_graph_nodes``), with moved parameters and non-trivial
    running statistics."""
    variables = tpu.random_batch_stats(tpu.jitter_params(
        {"params": setup.jstate.params, "batch_stats": setup.jstate.batch_stats}, seed=1), seed=2)
    batch = setup.batches[1]
    assert batch.meta.max_n_node <= setup.jaug["NeuralNetwork"]["Architecture"]["max_graph_nodes"]
    dtype_j, dtype_p = ((jnp.float32, torch.float32) if precision == "fp32"
                        else (jnp.bfloat16, torch.bfloat16))
    jstate = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=None, step=jnp.zeros((), jnp.int32))
    want = jax_make_predict_step(setup.jmodel, dtype_j)(jstate, jax.tree.map(jnp.asarray, batch))
    port = setup.port_model(variables["params"], variables["batch_stats"])
    got = make_predict_step(port, dtype_p)(batch_from_numpy(batch))
    for g, w in zip(_real_rows([t.numpy() for t in got], batch), _real_rows(want, batch)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **(TOL if precision == "fp32" else BF16_TOL))


def test_gps_gradients_match_jax(setup):
    """Loss and every parameter's gradient (the embeddings, each layer's
    local GIN, q/k/v/out through the masked softmax's VJP, the MLP and the
    three norms) and the updated running statistics."""
    batch = setup.batches[0]
    j_loss, _, j_grads, j_stats = _jax_grads(setup, batch)
    port = setup.port_model()
    p_loss, _, p_grads = _port_grads(port, batch)
    np.testing.assert_allclose(p_loss, j_loss, **TOL)
    assert set(p_grads) == set(j_grads)
    assert {"pos_emb.weight", "node_lin.weight", "graph_convs.1.attn.q.weight",
            "graph_convs.0.local.eps", "graph_convs.1.norm2.scale"} <= set(p_grads)
    for name, g in p_grads.items():
        np.testing.assert_allclose(g, j_grads[name], **TOL, err_msg=name)
    for name, v in port.state_dict().items():
        if name in j_stats:
            np.testing.assert_allclose(v.numpy(), j_stats[name], **TOL, err_msg=name)


def test_dense_path_matches_flat_path(setup):
    """The same parameters with ``max_graph_nodes`` below a graph's size
    force the exact flat attention over all node pairs; it computes what the
    dense blocks compute."""
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.ops import fused_softmax

    batch = batch_from_numpy(setup.batches[0])
    dense = setup.port_model()
    aug = copy.deepcopy(setup.aug)
    aug["NeuralNetwork"]["Architecture"]["max_graph_nodes"] = 2
    flat = create_model_config(aug, device="cpu")
    flat.load_state_dict(dense.state_dict())
    calls = []
    real = fused_softmax._MaskedSoftmax.apply

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    fused_softmax._MaskedSoftmax.apply = spy
    try:
        want = dense(batch)
        n_dense = len(calls)
        got = flat(batch)
    finally:
        fused_softmax._MaskedSoftmax.apply = real
    assert n_dense == 2 and len(calls) == 2, "dense path once per layer, flat path never"
    g, h, n, m = calls[0]
    assert (g, h, n, m) == (batch.num_graphs, 2, dense.spec.max_graph_nodes,
                            dense.spec.max_graph_nodes)
    for a, b in zip(got, want):
        torch.testing.assert_close(a[batch.graph_mask > 0], b[batch.graph_mask > 0],
                                   rtol=1e-5, atol=1e-6)


def test_short_run_training_on_the_cpu(tmp_path):
    """``run_training`` of the GPS-GIN (default dropout 0.25) for a few
    epochs on the CPU, then ``run_prediction`` of its state."""
    from hydragnn_tpu_torch import run_prediction, run_training

    cfg = gps_config(dropout=0.25)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 3
    samples = deterministic_graph_data(number_configurations=48, seed=19)
    history = []
    state, model, aug = run_training(copy.deepcopy(cfg), samples=tpu.port_samples(samples),
                                     device="cpu", path=str(tmp_path), seed=1, history=history)
    assert len(history) == 3 and state.step > 0
    assert all(np.isfinite(h["train_loss"]) for h in history)
    assert aug["NeuralNetwork"]["Architecture"]["max_graph_nodes"] >= 8
    assert model.spec.dropout == 0.25
    err, _, trues, preds = run_prediction(copy.deepcopy(cfg), state,
                                          samples=tpu.port_samples(samples), device="cpu")
    assert np.isfinite(err) and preds[0].shape == trues[0].shape


def test_server_refuses_request_without_positional_encodings(setup):
    """A GPS endpoint's signature carries the pe / rel_pe widths, so a
    request without encodings is refused at admission, typed, and a request
    with them is served."""
    from hydragnn_tpu_torch.serve import IncompatibleSampleError, PredictionServer, ServingConfig

    samples = tpu.port_samples(deterministic_graph_data(number_configurations=12, seed=8))
    for s in samples:
        attach_lap_pe(s, 2)
    server = PredictionServer(ServingConfig(flush_ms=1.0), device="cpu")
    server.add_model("gps", setup.port_model(), setup.aug, samples=samples, batch_size=4)
    server.start()
    try:
        bare = tpu.port_samples(deterministic_graph_data(number_configurations=1, seed=9))[0]
        with pytest.raises(IncompatibleSampleError, match="pe_width"):
            server.submit("gps", bare)
        heads = server.predict("gps", samples[:3])
        assert len(heads) == 3 and all(np.isfinite(h[0]).all() for h in heads)
        stats = server.stats()["gps"]
        assert stats["shed"] == 1 and stats["failed"] == 0 and stats["served"] == 3
    finally:
        server.stop()


@pytest.mark.parametrize("override,what", [
    # performer attention, GPS around GAT, graph-attribute conditioning
    # (tests/test_torch_gps_performer.py, tests/test_torch_gps_variants.py,
    # tests/test_torch_conditioning.py) and now ring attention
    # (tests/test_torch_ring_attention.py) are ported; without a process
    # group the ring is one block of the exact same-graph attention, so each
    # ring configuration answers what its multihead twin answers
    pytest.param({"global_attn_type": "ring", "use_graph_attr_conditioning": True},
                 "ring", id="override0-performer"),
    ({"global_attn_type": "ring"}, "ring"),
    pytest.param({"mpnn_type": "GAT", "global_attn_type": "ring"}, "ring",
                 id="override2-GPS around 'GAT'"),
])
def test_gps_variants_wait_for_their_slices(setup, override, what):
    from hydragnn_tpu_torch.models import create_model_config

    aug = copy.deepcopy(setup.aug)
    aug["NeuralNetwork"]["Architecture"].update(override)
    assert aug["NeuralNetwork"]["Architecture"]["global_attn_type"] == what
    ring = create_model_config(copy.deepcopy(aug), device="cpu", seed=0)
    assert all(m.ring for m in ring.modules() if hasattr(m, "ring"))
    aug["NeuralNetwork"]["Architecture"]["global_attn_type"] = "multihead"
    twin = create_model_config(aug, device="cpu", seed=0)
    jb = setup.batches[0]
    got = make_predict_step(ring)(batch_from_numpy(jb))
    want = make_predict_step(twin)(batch_from_numpy(jb))
    for g, w in zip(tpu.real_rows(got, jb, ring.spec), tpu.real_rows(want, jb, twin.spec)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)
