"""The pieces of the invariant conv stacks against the JAX package's, on
the same numpy inputs: the radial bases and cutoffs (``models/radial.py``),
``segment_std``, the extremes' tie rule, PNA's degree-scaled aggregate,
MFC's degree banks, the edge geometry of ``GraphBatch``, the
``update_config`` rules of PNA and CGCNN, SchNet's coordinate update and
MFC past ``max_neighbours``; and ``chip_smoke.py``'s canary table against
the reference's.

Tolerances: elementwise functions of fp32 inputs at rtol 1e-6 / atol 1e-6
(``jnp`` and torch evaluate ``sin``, ``exp`` and integer powers with other
roundings: a few ulps), and at rtol 1e-5 / atol 1e-5 where a few ulps are
amplified: the polynomial envelope and cutoff sum terms of up to 48 x^6 that
cancel towards the cutoff, and a Gaussian of width 0.1 A turns an offset's
ulp into 1e-5 of its value. Gradients at rtol 1e-5 / atol 1e-5, and 1e-4
for the same amplified functions (their slopes carry the same cancellations;
the Bessel basis's ``1/x`` envelope times ``sin`` also cancels at short
distances). Sums at rtol 1e-5 / atol 1e-6 (another order of additions); the
models at the fp32 bound of ``tests/test_torch_invariant_stacks.py``, rtol
2e-5 / atol 1e-5.
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
from hydragnn_tpu.graphs import segment as jseg
from hydragnn_tpu.models import pna as jpna
from hydragnn_tpu.models import radial as jrad
from hydragnn_tpu_torch.graphs import segment as pseg
from hydragnn_tpu_torch.models import pna as ppna
from hydragnn_tpu_torch.models import radial as prad

ELEMENTWISE = dict(rtol=1e-6, atol=1e-6)
AMPLIFIED = dict(rtol=1e-5, atol=1e-5)
SUMS = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=2e-5, atol=1e-5)


def _distances(n=400, cutoff=5.0, seed=0):
    """Edge lengths over [0.05, 1.2 cutoff], with 0 and the cutoff itself
    (below 0.05 A the Bessel basis's ``1/x`` envelope times ``sin`` cancels
    too far in fp32 for its gradient to compare)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.05, 1.2 * cutoff, size=n).astype(np.float32)
    d[:2] = [0.0, cutoff]
    return d


def _vjp_both(jfn, tfn, x, seed=1):
    """Values and input gradients (for one random cotangent) of a JAX and
    a torch function of one array."""
    jout, vjp = jax.vjp(jfn, jnp.asarray(x))
    ct = np.random.default_rng(seed).normal(size=np.shape(jout)).astype(np.float32)
    (jg,) = vjp(jnp.asarray(ct))
    t = torch.tensor(x, requires_grad=True)
    tout = tfn(t)
    tout.backward(torch.from_numpy(ct))
    return (np.asarray(jout), tout.detach().numpy()), (np.asarray(jg), t.grad.numpy())


@pytest.mark.parametrize("num_gaussians", [1, 20, 50])
def test_gaussian_smearing_matches_jax(num_gaussians):
    d = _distances()
    jmod = jrad.GaussianSmearing(start=0.0, stop=5.0, num_gaussians=num_gaussians)
    pmod = prad.GaussianSmearing(0.0, 5.0, num_gaussians)
    # jnp.linspace's offsets, to the ulp XLA may round the other way
    np.testing.assert_allclose(pmod.offset.numpy(),
                               np.asarray(jnp.linspace(0.0, 5.0, num_gaussians)), rtol=2.4e-7,
                               atol=0)
    (jv, pv), (jg, pg) = _vjp_both(lambda x: jmod.apply({}, x), pmod, d)
    np.testing.assert_allclose(pv, jv, **AMPLIFIED)
    np.testing.assert_allclose(pg, jg, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("exponent", [5, 6])
def test_bessel_basis_and_envelope_match_jax(exponent):
    """Values, the gradient in the distances and in the trainable
    frequencies (flax ``rbf.freq``)."""
    d = _distances()
    jmod = jrad.BesselBasis(num_radial=5, cutoff=5.0, envelope_exponent=exponent)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(d))
    pmod = prad.BesselBasis(5, 5.0, exponent)
    freq = np.asarray(variables["params"]["freq"]) + np.float32(0.01)
    with torch.no_grad():
        pmod.freq.copy_(torch.from_numpy(freq))
    np.testing.assert_allclose(np.arange(1, 6) * np.pi, np.asarray(variables["params"]["freq"]),
                               rtol=1e-7)
    params = {"params": {"freq": jnp.asarray(freq)}}
    (jv, pv), (jg, pg) = _vjp_both(lambda x: jmod.apply(params, x), pmod, d)
    np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pg, jg, rtol=1e-4, atol=1e-4)
    ct = np.random.default_rng(2).normal(size=jv.shape).astype(np.float32)
    jfreq = jax.grad(lambda p: jnp.sum(jmod.apply(p, jnp.asarray(d)) * ct))(params)
    pmod.freq.grad = None
    (pmod(torch.from_numpy(d)) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(pmod.freq.grad.numpy(), np.asarray(jfreq["params"]["freq"]),
                               rtol=1e-5, atol=1e-4)
    x = d / 5.0
    env = prad.polynomial_envelope(torch.from_numpy(x), exponent).numpy()
    np.testing.assert_allclose(env, np.asarray(jrad.polynomial_envelope(jnp.asarray(x),
                                                                        exponent)), **AMPLIFIED)
    assert (env[x >= 1.0] == 0).all()


@pytest.mark.parametrize("name", ["cosine_cutoff", "polynomial_cutoff", "sinc_expansion",
                                  "shifted_softplus", "chebyshev"])
def test_cutoffs_and_bases_match_jax(name):
    d = _distances()
    fns = {
        "cosine_cutoff": (lambda x: jrad.cosine_cutoff(x, 5.0),
                          lambda t: prad.cosine_cutoff(t, 5.0)),
        "polynomial_cutoff": (lambda x: jrad.polynomial_cutoff(x, 5.0, 6),
                              lambda t: prad.polynomial_cutoff(t, 5.0, 6)),
        "sinc_expansion": (lambda x: jrad.sinc_expansion(x, 6, 5.0),
                           lambda t: prad.sinc_expansion(t, 6, 5.0)),
        "shifted_softplus": (jrad.shifted_softplus, prad.shifted_softplus),
        "chebyshev": (lambda x: jrad.ChebyshevBasis(num_basis=8, cutoff=5.0).apply({}, x),
                      prad.ChebyshevBasis(8, 5.0)),
    }
    jfn, pfn = fns[name]
    if name == "shifted_softplus":
        d = (d - 3.0) * 10.0  # softplus over [-30, 30]
    (jv, pv), (jg, pg) = _vjp_both(jfn, pfn, d)
    np.testing.assert_allclose(pv, jv, **(AMPLIFIED if name == "polynomial_cutoff"
                                          else ELEMENTWISE))
    finite = np.isfinite(jg)
    grad_tol = 1e-4 if name == "polynomial_cutoff" else 1e-5
    np.testing.assert_allclose(pg[finite], jg[finite], rtol=grad_tol, atol=grad_tol)


def _segments(seed=0, n_segments=12, c=5):
    """Segment ids with an empty segment, a singleton, segments of equal
    rows (ties, zero variance) and rows whose extreme is exactly 0."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n_segments, size=80)).astype(np.int32)
    ids = ids[ids != 3]  # segment 3 empty
    data = rng.normal(size=(ids.shape[0], c)).astype(np.float32)
    data[ids == 5] = data[ids == 5][0]  # all rows equal
    data[ids == 7, 0] = 0.0  # a column whose max and min are 0, tied
    data[ids == 7, 1] = -np.abs(data[ids == 7, 1])
    data[np.flatnonzero(ids == 7)[:2], 1] = 0.0  # two rows tie at a max of 0
    ids[0] = n_segments - 1  # an unsorted id
    return ids, data, n_segments


@pytest.mark.parametrize("name", ["segment_std", "segment_max", "segment_min"])
def test_segment_reductions_and_their_gradients_match_jax(name):
    """``segment_std`` (two segment means) and the extremes, values and
    gradients, over empty segments, singletons, segments of equal rows and
    extremes tied at exactly 0: the extremes split a tie's gradient among
    the tied rows only, as ``jax.ops.segment_max`` does (a zeroed output
    counted itself among the ties of a 0 extreme)."""
    ids, data, n = _segments()
    jfn = lambda x: getattr(jseg, name)(x, jnp.asarray(ids), n)  # noqa: E731
    pfn = lambda t: getattr(pseg, name)(t, torch.from_numpy(ids), n)  # noqa: E731
    (jv, pv), (jg, pg) = _vjp_both(jfn, pfn, data)
    np.testing.assert_allclose(pv, jv, **SUMS)
    np.testing.assert_allclose(pg, jg, rtol=1e-5, atol=1e-5)


def test_degree_scaled_aggregate_matches_jax():
    """PNA's aggregate over padded edges (pad edges point at the dummy node
    N-1 with mask 0), a node without edges (its degree clamped at 1) and
    tied maxima, with the scalers of a histogram; values and gradients."""
    rng = np.random.default_rng(3)
    n, e, f = 10, 40, 4
    recv = np.sort(rng.integers(0, n - 2, size=e)).astype(np.int32)
    recv = recv[recv != 4]  # node 4 has no in-edge
    e = recv.shape[0]
    mask = np.ones(e, np.float32)
    mask[-5:] = 0.0
    recv[-5:] = n - 1
    msg = rng.normal(size=(e, f)).astype(np.float32)
    msg[recv == 2] = msg[recv == 2][0]  # ties everywhere at node 2
    hist = [3, 10, 20, 15, 4]
    delta, lin = jpna.log_degree_mean(hist), jpna.avg_degree_linear(hist)
    assert (delta, lin) == (ppna.log_degree_mean(hist), ppna.avg_degree_linear(hist))
    jfn = lambda m: jpna.degree_scaled_aggregate(  # noqa: E731
        m, jnp.asarray(recv), jnp.asarray(mask), n, delta, avg_deg_lin=lin)
    pfn = lambda m: ppna.degree_scaled_aggregate(  # noqa: E731
        m, torch.from_numpy(recv), torch.from_numpy(mask), n, delta, avg_deg_lin=lin)
    (jv, pv), (jg, pg) = _vjp_both(jfn, pfn, msg)
    assert pv.shape == (n, 16 * f)
    real = np.arange(n) != n - 1
    np.testing.assert_allclose(pv[real], jv[real], **SUMS)
    np.testing.assert_allclose(pg[mask > 0], jg[mask > 0], rtol=1e-5, atol=1e-5)
    assert np.isfinite(pv).all()


def test_degree_bank_product_matches_the_einsum():
    """MFC's banks as one product against JAX's ``einsum("ni,nio->no", x,
    w[deg])``: values and the gradients in ``x`` and the bank."""
    from hydragnn_tpu_torch.models.mfc import degree_bank_product

    rng = np.random.default_rng(4)
    n, d, c_in, c_out = 30, 6, 7, 5
    x = rng.normal(size=(n, c_in)).astype(np.float32)
    w = rng.normal(size=(d, c_in, c_out)).astype(np.float32)
    deg = rng.integers(0, d, size=n)
    ct = rng.normal(size=(n, c_out)).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, b: jnp.einsum("ni,nio->no", a, b[jnp.asarray(deg)]),
                        jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(ct))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    onehot = torch.from_numpy(deg)[:, None] == torch.arange(d)
    out = degree_bank_product(tx, onehot, tw)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **SUMS)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **SUMS)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), **SUMS)


def test_edge_vectors_and_lengths_match_jax():
    from hydragnn_tpu.graphs.batching import collate, compute_pad_spec
    from hydragnn_tpu_torch.convert import batch_from_numpy

    samples = deterministic_graph_data(number_configurations=8, seed=7)
    batch = collate(samples, compute_pad_spec(samples, 8))
    jb = jax.tree.map(jnp.asarray, batch)
    pb = batch_from_numpy(batch)
    np.testing.assert_array_equal(pb.edge_vectors().numpy(), np.asarray(jb.edge_vectors()))
    np.testing.assert_array_equal(pb.edge_lengths().numpy(), np.asarray(jb.edge_lengths()))


def _bcc_config(stack, **arch):
    from test_config import CI_CONFIG

    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Architecture"].update(mpnn_type=stack, **arch)
    return cfg


@pytest.mark.parametrize("stack,arch", [
    ("PNA", {}),
    ("PNAPlus", {"pna_deg": [1, 4, 9]}),
    ("CGCNN", {"hidden_dim": 16}),
    ("CGCNN", {"edge_features": ["length"]}),
    ("SchNet", {"edge_features": ["length"]}),
    ("SAGE", {"edge_features": ["length"]}),
])
def test_update_config_rules_match_jax(stack, arch):
    """PNA's in-degree histogram and ``max_neighbours = len(pna_deg) - 1``
    (a given histogram kept), CGCNN's hidden width (its input width) and
    ``edge_dim`` 0, the edge features' count for the stacks that read them
    and the refusal for the others."""
    from hydragnn_tpu_torch.config import ModelSpec, update_config

    samples = deterministic_graph_data(number_configurations=20, seed=1)
    cfg = _bcc_config(stack, **arch)
    if stack == "SAGE":
        for fn, s in ((jax_update_config, samples), (update_config, tpu.port_samples(samples))):
            with pytest.raises(ValueError, match="Edge features can only be used"):
                fn(copy.deepcopy(cfg), s)
        return
    want = jax_update_config(copy.deepcopy(cfg), samples)["NeuralNetwork"]["Architecture"]
    aug = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
    got = aug["NeuralNetwork"]["Architecture"]
    for key in ("pna_deg", "max_neighbours", "hidden_dim", "edge_dim", "input_dim"):
        assert got[key] == want[key], key
    spec = ModelSpec.from_config(aug)
    assert spec.pna_deg == (tuple(want["pna_deg"]) if want["pna_deg"] else None)
    if stack == "PNA":
        assert sum(got["pna_deg"]) == sum(s.num_nodes for s in samples)


def _setup(stack, **overrides):
    from test_torch_invariant_stacks import Setup

    return Setup(stack, "four_heads", **overrides)


def test_schnet_positions_under_equivariance_match_jax():
    """SchNet with ``equivariance``: the positions its conv stack returns
    (every layer but the last moves them by the gated sender mean) and the
    node features, against JAX's ``encode``."""
    from hydragnn_tpu_torch.convert import batch_from_numpy

    s = _setup("SchNet", equivariance=True, num_conv_layers=3)
    j_inv, j_pos = s.jmodel.apply(s.variables, jax.tree.map(jnp.asarray, s.batch),
                                  method=s.jmodel.encode)
    with torch.no_grad():
        p_inv, p_pos = s.port.encode(batch_from_numpy(s.batch))
    nm = np.asarray(s.batch.node_mask) > 0
    moved = np.abs(np.asarray(j_pos) - np.asarray(s.batch.pos))[nm].max()
    assert moved > 1e-7, "the coordinate update moved nothing"
    np.testing.assert_allclose(p_pos.numpy()[nm], np.asarray(j_pos)[nm], **MODEL)
    np.testing.assert_allclose(p_inv.numpy()[nm], np.asarray(j_inv)[nm], **MODEL)
    assert "graph_convs.0.coord_mlp_0.weight" in dict(s.port.named_parameters())
    assert "graph_convs.2.coord_mlp_0.weight" not in dict(s.port.named_parameters())


def test_mfc_past_max_neighbours_matches_jax():
    """MFC with ``max_neighbours`` 3 on the BCC lattice, where most nodes
    have more in-edges: their degrees clamp to the last bank."""
    from hydragnn_tpu_torch.convert import batch_from_numpy
    from hydragnn_tpu.train.step import TrainState
    from hydragnn_tpu.train.step import make_predict_step as jax_make_predict_step
    from hydragnn_tpu_torch.train.step import make_predict_step

    s = _setup("MFC", max_neighbours=3)
    recv = np.asarray(s.batch.receivers)[np.asarray(s.batch.edge_mask) > 0]
    assert (np.bincount(recv) > 3).any()
    assert s.port.graph_convs[0].w_root.shape[0] == 4
    state = TrainState(params=s.variables["params"], batch_stats=s.variables["batch_stats"],
                       opt_state=None, step=jnp.zeros((), jnp.int32))
    want = jax_make_predict_step(s.jmodel, jnp.float32)(state, jax.tree.map(jnp.asarray,
                                                                            s.batch))
    got = make_predict_step(s.port, torch.float32)(batch_from_numpy(s.batch))
    gm = np.asarray(s.batch.graph_mask) > 0
    np.testing.assert_allclose(got[0].numpy()[gm], np.asarray(want[0])[gm], **MODEL)


def test_chip_smoke_canaries_are_the_reference_gates():
    """``chip_smoke.py``'s canaries of the six stacks carry
    ``tests/test_training_e2e.py``'s ``THRESHOLDS`` and ``ARCH_OVERRIDES``
    and the 4-head configuration of ``test_invariant_arch_convergence``."""
    import chip_smoke
    from test_training_e2e import ARCH_OVERRIDES, THRESHOLDS

    for stack in ("SAGE", "MFC", "SchNet", "PNA", "PNAPlus", "CGCNN"):
        n, seed, epochs, rmse, mae, held = chip_smoke.CANARIES[stack.lower()]
        assert (n, seed, epochs, held) == (500, 7, 100, None), stack
        assert (rmse, mae) == THRESHOLDS[stack], stack
        cfg = chip_smoke.canary_config(stack.lower())
        arch = cfg["NeuralNetwork"]["Architecture"]
        assert arch["mpnn_type"] == stack
        assert {k: arch[k] for k in ARCH_OVERRIDES[stack]} == ARCH_OVERRIDES[stack], stack
        assert arch["task_weights"] == [20.0, 1.0, 1.0, 1.0]
        assert cfg["NeuralNetwork"]["Training"]["batch_size"] == 16
        assert cfg["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"] == 0.01
        assert cfg["NeuralNetwork"]["Variables_of_interest"]["type"] == [
            "graph", "node", "node", "node"]
