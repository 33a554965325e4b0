"""The pieces of the geometric conv stacks against the JAX package's, on the
same numpy inputs: the real spherical harmonics, Gaunt tables and tensor
products (``models/harmonics.py``), the spherical Bessel functions with
their analytic derivative and DimeNet's spherical basis
(``models/spherical.py``), the triplets (``graphs/triplets.py``) and their
collation, certificates and CSR views, PNAEq's scalers, MACE's
``avg_num_neighbors``; and the JAX package's own property tests of the
harmonics (``tests/test_harmonics.py``) re-run on the port.

Tolerances: the harmonics and spherical Bessel values of fp32 inputs at
atol 1e-6 of values of size <= ~3 (torch and XLA round products of a few
factors in other orders: a few ulps); the gradients at rtol 1e-5 / atol
1e-5; sums (the tensor product's einsum over the ``m`` axes, the degree
aggregate) at rtol 1e-5 / atol 1e-6. The Gaunt tables, the Bessel roots and
their normalisers are float64 host computations of the same formulas and
must be equal. The property tests keep ``tests/test_harmonics.py``'s own
tolerances.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.models import harmonics as jh
from hydragnn_tpu.models import pna as jpna
from hydragnn_tpu.models import spherical as jsph
from hydragnn_tpu_torch.models import harmonics as ph
from hydragnn_tpu_torch.models import pna as ppna
from hydragnn_tpu_torch.models import spherical as psph

VALUES = dict(rtol=1e-6, atol=1e-6)
GRADS = dict(rtol=1e-5, atol=1e-5)
SUMS = dict(rtol=1e-5, atol=1e-6)


def unit_vectors(n=512, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _vectors(n=256, seed=0):
    """Edge vectors of lengths 0.1-5 A, with a zero one (a pad edge)."""
    rng = np.random.default_rng(seed)
    v = (unit_vectors(n, seed) * rng.uniform(0.1, 5.0, size=(n, 1))).astype(np.float32)
    v[0] = 0.0
    return v


# -- harmonics --------------------------------------------------------------------


@pytest.mark.parametrize("l_max", [1, 2, 3, 5])
def test_spherical_harmonics_and_gradients_match_jax(l_max):
    v = _vectors()
    ct = [np.random.default_rng(l).normal(size=(v.shape[0], 2 * l + 1)).astype(np.float32)
          for l in range(l_max + 1)]

    def jloss(x):
        return sum(jnp.sum(y * c) for y, c in zip(jh.spherical_harmonics(x, l_max), ct))

    want = [np.asarray(y) for y in jh.spherical_harmonics(jnp.asarray(v), l_max)]
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(v)))
    t = torch.from_numpy(v).requires_grad_()
    got = ph.spherical_harmonics(t, l_max)
    sum((y * torch.from_numpy(c)).sum() for y, c in zip(got, ct)).backward()
    for l, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-6 * (2 * l + 1), rtol=0,
                                   err_msg=f"l={l}")
    np.testing.assert_allclose(t.grad.numpy(), jg, **GRADS)
    assert np.isfinite(t.grad.numpy()).all(), "the pad edge's gradient is finite"


@pytest.mark.parametrize("path", [(0, 0, 0), (1, 1, 0), (1, 1, 2), (1, 2, 1), (2, 2, 2),
                                  (3, 2, 1), (4, 2, 2), (2, 1, 2)])
def test_gaunt_tables_equal_jax(path):
    np.testing.assert_array_equal(ph.gaunt_array(*path), jh.gaunt_array(*path))


@pytest.mark.parametrize("lmax", [(1, 1, 1), (1, 2, 1), (2, 2, 2)])
def test_coupling_paths_equal_jax(lmax):
    assert ph.coupling_paths(*lmax) == jh.coupling_paths(*lmax)
    assert ph.irreps_dim(lmax[0]) == jh.irreps_dim(lmax[0])


@pytest.mark.parametrize("weighted", [False, True])
def test_tensor_product_matches_jax(weighted):
    """Two irreps dicts ``{l: [E, 2l+1, C]}`` through the Gaunt product, with
    and without per-path channel weights: values and both inputs'
    gradients."""
    rng = np.random.default_rng(5)
    e, c = 40, 6
    u = {l: rng.normal(size=(e, 2 * l + 1, c)).astype(np.float32) for l in range(2)}
    v = {l: rng.normal(size=(e, 2 * l + 1, c)).astype(np.float32) for l in range(3)}
    paths = jh.coupling_paths(1, 2, 2)
    w = {p: rng.normal(size=(e, 1, c)).astype(np.float32) for p in paths} if weighted else None

    def jfn(uu, vv):
        out = jh.tensor_product(uu, vv, 2, None if w is None else
                                {k: jnp.asarray(x) for k, x in w.items()})
        return sum(jnp.sum(o * o) for o in out.values()), out

    (jl, jout), jg = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(x) for k, x in u.items()}, {k: jnp.asarray(x) for k, x in v.items()})
    tu = {k: torch.from_numpy(x).requires_grad_() for k, x in u.items()}
    tv = {k: torch.from_numpy(x).requires_grad_() for k, x in v.items()}
    holder = torch.nn.Module()
    ph.gaunt_buffers(holder, paths)
    out = ph.tensor_product(tu, tv, 2, lambda p: getattr(holder, ph.gaunt_name(p)),
                            None if w is None else {k: torch.from_numpy(x) for k, x in w.items()})
    assert list(out) == list(jout), "the output blocks in the JAX package's order"
    sum((o * o).sum() for o in out.values()).backward()
    for l in out:
        np.testing.assert_allclose(out[l].detach().numpy(), np.asarray(jout[l]), **SUMS)
    for got, want in ((tu, jg[0]), (tv, jg[1])):
        for l in got:
            np.testing.assert_allclose(got[l].grad.numpy(), np.asarray(want[l]), **GRADS)


# -- tests/test_harmonics.py, re-run on the port ------------------------------------


def test_recurrence_reproduces_explicit_blocks():
    v = unit_vectors()
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    explicit = ph._sh_blocks(x, y, z, 3, np)
    recur = ph._sh_recurrence(x, y, z, 0, 3, np)
    for l, (a, b) in enumerate(zip(explicit, recur)):
        np.testing.assert_allclose(a, b, atol=1e-12, err_msg=f"l={l}")


@pytest.mark.parametrize("l", [4, 5, 6])
def test_high_l_component_normalization(l):
    v = unit_vectors(seed=l)
    y = ph.spherical_harmonics(torch.from_numpy(v), l)[l].numpy()
    np.testing.assert_allclose(np.sum(y**2, axis=-1), 2 * l + 1, rtol=1e-5)


def test_high_l_orthogonality():
    x, y, z, w = ph._quadrature(10)
    blocks = ph._sh_blocks(x, y, z, 5, np)
    ys = np.concatenate(blocks, axis=-1)
    gram = np.einsum("q,qa,qb->ab", w / (4 * np.pi), ys, ys)
    np.testing.assert_allclose(gram, np.eye(ys.shape[1]), atol=1e-10)


def test_high_l_rotation_equivariance():
    theta = 0.83
    rot = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                    [0, 0, 1]])
    v = unit_vectors(64, seed=4)
    for l in (4, 5):
        y = ph.spherical_harmonics(torch.from_numpy(v), l)[l].numpy()
        yr = ph.spherical_harmonics(torch.from_numpy(v @ rot.T), l)[l].numpy()
        np.testing.assert_allclose(np.sum(y**2, axis=-1), np.sum(yr**2, axis=-1), rtol=1e-5)
    y4 = ph.spherical_harmonics(torch.from_numpy(v), 4)[4].numpy()
    y4r = ph.spherical_harmonics(torch.from_numpy(v @ rot.T), 4)[4].numpy()
    np.testing.assert_allclose(y4 @ y4.T, y4r @ y4r.T, rtol=1e-4, atol=1e-6)


def test_gaunt_selection_rules_high_l():
    assert np.abs(ph.gaunt_array(4, 2, 2)).max() > 0
    assert np.abs(ph.gaunt_array(4, 2, 3)).max() == 0
    assert np.abs(ph.gaunt_array(4, 1, 2)).max() == 0
    paths = ph.coupling_paths(4, 4, 5)
    assert (4, 4, 4) in paths and (4, 1, 5) in paths


def test_gaunt_l0_coupling_is_identity():
    for l in (4, 5):
        np.testing.assert_allclose(ph.gaunt_array(0, l, l)[0], np.eye(2 * l + 1), atol=1e-10)


def test_padding_vectors_stay_finite_high_l():
    v = torch.zeros((4, 3), requires_grad=True)
    ys = ph.spherical_harmonics(v, 5)
    for block in ys:
        assert torch.isfinite(block).all()
    sum(y.sum() for y in ys).backward()
    assert torch.isfinite(v.grad).all()


# -- spherical Bessel functions and DimeNet's basis ----------------------------------


def test_bessel_roots_and_normalizers_equal_jax():
    np.testing.assert_array_equal(psph.spherical_bessel_roots(7, 6),
                                  np.asarray(jsph.spherical_bessel_roots(7, 6)))
    np.testing.assert_array_equal(psph.bessel_normalizers(7, 6),
                                  np.asarray(jsph._normalizers(7, 6)))


@pytest.mark.parametrize("l_max", [0, 1, 3, 6])
def test_spherical_jn_and_its_derivative_match_jax(l_max):
    """Values over [0, 25] (0 and below the 0.05 clamp included) and the
    analytic derivative, against the JAX package's custom JVP."""
    x = np.concatenate([[0.0, 0.01, 0.05], np.linspace(0.06, 25.0, 800)]).astype(np.float32)
    want = np.asarray(jsph._sph_jn_stack(l_max, jnp.asarray(x)))
    jg = np.asarray(jax.grad(lambda t: jnp.sum(jsph._sph_jn_stack(l_max, t)))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    got = psph.spherical_jn(l_max, t)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **VALUES)
    np.testing.assert_allclose(t.grad.numpy(), jg, **GRADS)


@pytest.mark.parametrize("l", [0, 2, 5])
def test_spherical_jn_second_derivative_is_finite_and_analytic(l):
    """The derivative is built from the same Function, so its own
    derivative is the analytic one again: finite everywhere (the blended
    recurrences overflow fp32 in the branch they do not select), and equal
    to a central difference of the analytic first derivative in fp64."""
    x = torch.linspace(0.0, 30.0, 3001, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(psph.spherical_jn(l, x)[l].sum(), x, create_graph=True)
    (g2,) = torch.autograd.grad(g.sum(), x)
    assert torch.isfinite(g2).all()
    xs = torch.linspace(1.0, 20.0, 200, dtype=torch.float64)
    h = 1e-5

    def d1(t):
        t = t.clone().requires_grad_()
        return torch.autograd.grad(psph.spherical_jn(l, t)[l].sum(), t)[0]

    t = xs.clone().requires_grad_()
    (gg,) = torch.autograd.grad(psph.spherical_jn(l, t)[l].sum(), t, create_graph=True)
    (second,) = torch.autograd.grad(gg.sum(), t)
    numeric = (d1(xs + h) - d1(xs - h)) / (2 * h)
    np.testing.assert_allclose(second.numpy(), numeric.numpy(), rtol=1e-5, atol=1e-7)


def test_spherical_basis_matches_jax():
    """DimeNet's basis of triplets (zero-length pad triplets included):
    values and the gradients in the lengths and the angles."""
    rng = np.random.default_rng(7)
    t, e = 300, 120
    dist = rng.uniform(0.3, 5.5, size=e).astype(np.float32)
    dist[-1] = 0.0
    idx_kj = rng.integers(0, e, size=t).astype(np.int32)
    idx_kj[-10:] = e - 1
    angle = rng.uniform(0.0, np.pi, size=t).astype(np.float32)
    ct = rng.normal(size=(t, 42)).astype(np.float32)

    def jfn(d, a):
        return jnp.sum(jsph.spherical_basis(d, a, jnp.asarray(idx_kj), 7, 6, 5.0, 5) * ct)

    want = np.asarray(jsph.spherical_basis(jnp.asarray(dist), jnp.asarray(angle),
                                           jnp.asarray(idx_kj), 7, 6, 5.0, 5))
    jgd, jga = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(dist), jnp.asarray(angle))
    td = torch.from_numpy(dist).requires_grad_()
    ta = torch.from_numpy(angle).requires_grad_()
    roots = torch.from_numpy(psph.spherical_bessel_roots(7, 6).astype(np.float32))
    norms = torch.from_numpy(psph.bessel_normalizers(7, 6).astype(np.float32))
    got = psph.spherical_basis(td[torch.from_numpy(idx_kj).long()], ta, roots, norms, 5.0, 5)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got[-10:] == 0).all(), "pad triplets give exact zeros"
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgd), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jga), rtol=1e-4, atol=1e-4)


# -- triplets -----------------------------------------------------------------------


def _random_graph(n, e, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, size=e).astype(np.int32)
    r = rng.integers(0, n, size=e).astype(np.int32)
    keep = s != r
    return s[keep], r[keep]



@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_integer_powers_round_as_jax(dtype):
    """``radial.integer_pow`` is bit-equal to ``jnp``'s ``x ** n``, which
    rounds each product of its repeated squaring."""
    from hydragnn_tpu_torch.models.radial import integer_pow

    x = np.random.default_rng(0).uniform(0.0, 1.2, 4096).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for n in range(1, 9):
        want = np.asarray(jax.jit(lambda a: a ** n)(xj), np.float32)
        np.testing.assert_array_equal(integer_pow(xt, n).float().numpy(), want, err_msg=f"n={n}")


def test_bf16_envelopes_round_as_jax():
    """DimeNet's and PNAPlus's Bessel envelope and MACE's polynomial cutoff
    are bit-equal to the JAX package's in bf16, where their terms cancel
    (ROADMAP queue C item 14). With ``torch.pow``'s single rounding of the
    powers, the envelope differed on 29% of these inputs, by up to 0.25
    (``tests/bf16_readings.py``)."""
    from hydragnn_tpu.models import radial as jrad
    from hydragnn_tpu_torch.models import radial as prad

    x = np.random.default_rng(0).uniform(0.0, 1.2, 4096).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for want, got in [(jax.jit(lambda a: jrad.polynomial_envelope(a, 5))(xj),
                       prad.polynomial_envelope(xt, 5)),
                      (jax.jit(lambda a: jrad.polynomial_cutoff(a * 5.0, 5.0))(xj),
                       prad.polynomial_cutoff(xt * 5.0, 5.0))]:
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))

@pytest.mark.parametrize("n,e,seed", [(1, 0, 0), (5, 12, 1), (30, 200, 2), (64, 900, 3)])
def test_build_triplets_equals_jax(n, e, seed):
    from hydragnn_tpu.graphs.triplets import build_triplets as jbuild
    from hydragnn_tpu_torch.graphs.triplets import build_triplets

    s, r = _random_graph(n, e, seed)
    got, want = build_triplets(s, r), jbuild(s, r)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int32
    assert np.all(np.diff(got[1]) >= 0), "idx_ji comes out sorted"


def test_dimenet_preprocessing_collates_like_jax():
    """``dataset_loading_and_splitting`` attaches the triplets for DimeNet,
    collate offsets and pads them as the JAX package's does, certifies
    ``idx_ji`` sorted, and the CSR views of ``idx_ji`` (no permutation) and
    ``idx_kj`` (argsorted) cover the E edge rows."""
    from conftest import random_molecule_samples
    from hydragnn_tpu.graphs.batching import collate as jcollate
    from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jload
    from hydragnn_tpu_torch.graphs.batching import collate
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
    from test_torch_geometric_stacks import molecule_config

    cfg = molecule_config("DimeNet")
    cfg["NeuralNetwork"]["Training"]["batch_size"] = 8
    samples = random_molecule_samples(24, seed=3)
    jl = jload(copy.deepcopy(cfg), samples=tpu.jax_samples_copy(samples))
    pl = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=tpu.port_samples(samples))
    js, ps = jl[0].samples, pl[0].samples
    assert all("idx_kj" in s.extras for s in ps)
    jb = jcollate(js[:8], jl[0].pad)
    pb = collate(ps[:8], pl[0].pad)
    for f in ("idx_kj", "idx_ji", "triplet_mask", "senders", "receivers", "z"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)), f)
    assert pb.meta.ji_sorted
    ji, kj = pb.csr("idx_ji"), pb.csr("idx_kj")
    assert ji.perm is None and kj.perm is not None
    assert (ji.num_segments, ji.num_ids) == (pb.num_edges, pb.idx_ji.shape[0])
    counts = np.bincount(pb.idx_ji.numpy(), minlength=pb.num_edges)
    np.testing.assert_array_equal(np.diff(ji.ptr.numpy()), counts)


# -- PNAEq's scalers, MACE's neighbour count -------------------------------------------


def test_pnaeq_aggregate_with_inverse_linear_matches_jax():
    """The degree-scaled aggregate at the senders with PNAEq's five scalers
    (``inverse_linear`` added) and the clamped mean degree."""
    rng = np.random.default_rng(9)
    n, e, f = 12, 50, 3
    send = rng.integers(0, n - 2, size=e).astype(np.int32)
    mask = np.ones(e, np.float32)
    mask[-6:] = 0.0
    send[-6:] = n - 1
    msg = rng.normal(size=(e, f)).astype(np.float32) * mask[:, None]
    hist = [0, 2, 7, 3]
    delta = jpna.log_degree_mean(hist)
    lin = max(jpna.avg_degree_linear(hist), 1.0)
    jfn = jax.grad(lambda m: jnp.sum(jpna.degree_scaled_aggregate(
        m, jnp.asarray(send), jnp.asarray(mask), n, delta,
        aggregators=("mean", "min", "max", "std"),
        scalers=("identity", "amplification", "attenuation", "linear", "inverse_linear"),
        avg_deg_lin=lin) ** 2))
    want = np.asarray(jpna.degree_scaled_aggregate(
        jnp.asarray(msg), jnp.asarray(send), jnp.asarray(mask), n, delta,
        aggregators=("mean", "min", "max", "std"),
        scalers=("identity", "amplification", "attenuation", "linear", "inverse_linear"),
        avg_deg_lin=lin))
    t = torch.from_numpy(msg).requires_grad_()
    got = ppna.degree_scaled_aggregate(t, torch.from_numpy(send), torch.from_numpy(mask), n,
                                       delta, avg_deg_lin=lin, scalers=ppna.PNAEQ_SCALERS)
    (got**2).sum().backward()
    assert got.shape == (n, 20 * f)
    real = np.arange(n) != n - 1
    np.testing.assert_allclose(got.detach().numpy()[real], want[real], **SUMS)
    jg = np.asarray(jfn(jnp.asarray(msg)))
    np.testing.assert_allclose(t.grad.numpy()[mask > 0], jg[mask > 0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stack", ["MACE", "PNAEq", "PAINN", "DimeNet"])
def test_update_config_geometric_rules_match_jax(stack):
    """MACE's ``avg_num_neighbors`` (edges per node of the training set, a
    given value kept), PNAEq's degree histogram, and the fields the four
    stacks read reaching ``ModelSpec``."""
    from hydragnn_tpu.config import update_config as jax_update_config
    from hydragnn_tpu.models import create_model_config as jax_create_model_config
    from hydragnn_tpu_torch.config import ModelSpec, update_config
    from hydragnn_tpu.datasets import deterministic_graph_data
    from test_torch_geometric_train import stack_config

    samples = deterministic_graph_data(number_configurations=20, seed=1)
    cfg = stack_config(stack)
    want = jax_update_config(copy.deepcopy(cfg), samples)
    got = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
    wa, ga = want["NeuralNetwork"]["Architecture"], got["NeuralNetwork"]["Architecture"]
    for key in ("avg_num_neighbors", "pna_deg", "max_neighbours"):
        assert ga.get(key) == wa.get(key), key
    if stack == "MACE":
        assert ga["avg_num_neighbors"] == pytest.approx(
            sum(s.num_edges for s in samples) / sum(s.num_nodes for s in samples))
        kept = copy.deepcopy(cfg)
        kept["NeuralNetwork"]["Architecture"]["avg_num_neighbors"] = 3.5
        assert update_config(kept, tpu.port_samples(samples))[
            "NeuralNetwork"]["Architecture"]["avg_num_neighbors"] == 3.5
    jspec, spec = jax_create_model_config(want).spec, ModelSpec.from_config(got)
    for key in ("radial_type", "num_radial", "num_spherical", "basis_emb_size",
                "int_emb_size", "out_emb_size", "num_before_skip", "num_after_skip",
                "envelope_exponent", "max_ell", "node_max_ell", "correlation",
                "avg_num_neighbors"):
        assert getattr(spec, key) == getattr(jspec, key), key


def test_flattened_segment_sum_of_3d_messages_matches_jax():
    """The ``[E, 3, F]`` vector messages reach the segment sum as ``[E, 3
    F]`` (fp32 accumulation) and come back ``[N, 3, F]``; in bf16 the port
    sums in fp32 where XLA sums bf16 in bf16 (ROADMAP queue C), so the bf16
    difference is held to the JAX sum's own distance from an fp32 sum plus
    one bf16 rounding."""
    from hydragnn_tpu.graphs import segment as jseg
    from hydragnn_tpu_torch.graphs import segment as pseg

    rng = np.random.default_rng(11)
    n, e = 30, 400
    ids = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    x = rng.normal(size=(e, 3, 8)).astype(np.float32)
    got = pseg.segment_sum(torch.from_numpy(x), torch.from_numpy(ids), n)
    want = np.asarray(jseg.segment_sum(jnp.asarray(x), jnp.asarray(ids), n))
    assert got.shape == (n, 3, 8)
    np.testing.assert_allclose(got.numpy(), want, **SUMS)
    xb = jnp.asarray(x, jnp.bfloat16)
    got16 = pseg.segment_sum(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(ids), n)
    want16 = np.asarray(jseg.segment_sum(xb, jnp.asarray(ids), n), np.float32)
    exact = np.asarray(jseg.segment_sum(jnp.asarray(np.asarray(xb, np.float32)),
                                        jnp.asarray(ids), n))
    bound = np.abs(want16 - exact) + 2.0**-8 * np.abs(exact) + 1e-6
    assert got16.dtype == torch.bfloat16
    assert (np.abs(got16.float().numpy() - want16) <= bound).all()
    assert (np.abs(got16.float().numpy() - exact) <= 2.0**-8 * np.abs(exact) + 1e-6).all(), \
        "the port's bf16 sum is the fp32 sum rounded once"
