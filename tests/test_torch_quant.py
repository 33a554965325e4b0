"""Int8 quantized serving in the port (``hydragnn_tpu_torch.ops.quant_matmul``,
``hydragnn_tpu_torch.serve.quant`` and the endpoint's int8 half) against the
JAX package's, on the CPU, where ``quant_dense`` takes its plain version.

The layer: the plain version's int8 codes and int32 accumulators equal the
JAX route's exactly and ``y`` lies within 1 ulp of ``|y|`` of the jitted
JAX reference and of the Pallas kernel in interpret mode. The port divides
``x / s_x`` as an IEEE division, as the JAX expression reads and as eager
JAX computes it; under ``jax.jit`` XLA rewrites a division by the constant
``s_x`` into a multiply by its fp32 reciprocal, which moves a code by 1
where ``x / s_x`` lies within one rounding of a tie (about one value in a
million). The codes are held against the eager JAX route exactly and
against the jitted one everywhere the two roundings agree.

The models: the tier-1 GIN (four heads), GAT and GPS-GIN of
``tests/test_torch_{train_step,gat,gps}.py`` (hidden 8, 2 conv layers) from
the JAX model's moved parameters and non-trivial running statistics. The
calibrated scale tables and the int8 weight tables equal the JAX package's
key by key through ``convert.port_module_name`` (scales within fp32
reordering of the forward, weights exactly). The fp32 quantized steps,
given the same tables, agree with JAX's to a few ulps: with the same codes
every int8 layer is exact, and no code flips on these batches (the steps
agree to the bit). Each head's int8 error is held far above that
tolerance, so a step that did not quantize, or flipped codes, fails. The
certified bounds, each package calibrated by its own fp32 forward, agree
within a few ulps of the answers. The bf16 steps round conv layer 0 to
neighbouring bf16 values on the two sides, which flips codes: their
tolerance is set by the head's int8 error.
"""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.ops import quant_matmul as jq
from hydragnn_tpu.serve.predictor import Predictor as JaxPredictor
from hydragnn_tpu.serve.quant import certify_quant_error as jax_certify_quant_error
from hydragnn_tpu.serve.quant import collect_activation_scales as jax_collect_scales
from hydragnn_tpu.serve.quant import make_quantized_predict_step as jax_make_quant_step
from hydragnn_tpu.serve.quant import quantize_dense_weights as jax_quantize_dense_weights
from hydragnn_tpu.train.step import TrainState as JaxTrainState
from hydragnn_tpu_torch.convert import batch_from_numpy, port_module_name
from hydragnn_tpu_torch.graphs.batching import PadSpec
from hydragnn_tpu_torch.models.common import intercept_dense
from hydragnn_tpu_torch.ops import fused_scatter as fs
from hydragnn_tpu_torch.ops import quant_matmul as pq
from hydragnn_tpu_torch.serve import (
    PredictionServer,
    Predictor,
    QuantizationError,
    ServingConfig,
)
from hydragnn_tpu_torch.serve import quant as sq
from hydragnn_tpu_torch.serve.batcher import serving_collate
from test_torch_gat import gat_config
from test_torch_gps import gps_config
from test_torch_train_step import Setup, four_head_config

# (M, K, N): a ragged row count, GIN conv layer 0 (K = 1), a head's output
# Dense (N = 1), a wide square layer (GAT's concatenated heads at 6 x 8)
SHAPES = [(37, 24, 16), (50, 1, 8), (33, 16, 1), (21, 48, 48)]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# scales are abs-maxima of fp32 activations that XLA and PyTorch sum in other
# orders through the layers before them
SCALE_RTOL = 1e-5
# the quantized fp32 steps from the same tables: with the same codes every
# int8 layer is exact, so the steps differ only as XLA's and PyTorch's fp32
# forwards do around them; they agree to the bit on these batches (no code
# flips), and may differ by STEP_ULPS ulps of the head's largest answer
STEP_ULPS = 4
# each package calibrated by its own fp32 forward: the scales differ in
# their last bits, the codes do not; the bounds, maxima of |int8 - fp32|
# over answers of size ~2.6, agree within 7.2e-7 (3 ulps of 2.6) measured
BOUND_ATOL = 4e-6
# a head's int8 error (and bound) must exceed the tolerance above by this
# factor, so that a step that does not quantize cannot pass (measured: the
# smallest int8 error at these widths is 1.2e-3, the smallest bound 1.2e-3)
ERR_OVER_TOL = 100.0
# the bf16 steps run conv layer 0 in bf16 on both sides, where the two round
# to neighbouring bf16 values (the bf16 forward tests allow 3e-2); each such
# difference moves the next layer's x / s_x by ~2^-8 of itself, which flips
# a share of its codes, and each flip is one quantization step of the noise
# whose sum the int8 error of the head measures: the steps may differ by a
# quarter of that error on top of 3e-2 (measured: at most 0.14 of it)
BF16_ATOL, BF16_ERR_SHARE = 3e-2, 0.25


def _ulp(a: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(a.astype(np.float32)))


def _draw(shape, dtype_name, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    if dtype_name == "bf16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return x, w, b


# -- the layer -----------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_weight_matches_jax(shape):
    _, w, _ = _draw(shape, "fp32", 0)
    jw_q, js_w = jq.quantize_weight(jnp.asarray(w))
    w_q, s_w = pq.quantize_weight(torch.from_numpy(w))
    assert w_q.dtype == torch.int8 and s_w.dtype == torch.float32
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(js_w))


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reference_quant_dense_matches_jax(shape, dtype, with_bias):
    """Codes and accumulators exact; ``y`` within 1 ulp of the jitted JAX
    reference and of the interpret-mode Pallas kernel; the analytic
    quantization bound of ``tests/test_serve_quant.py`` against the fp32
    product."""
    jdt, pdt = DTYPES[dtype]
    x, w, b = _draw(shape, dtype, 1)
    jx = jnp.asarray(x, jdt)
    jw_q, js_w = jq.quantize_weight(jnp.asarray(w))
    s_x = float(np.abs(x).max()) / 127.0
    jb = jnp.asarray(b) if with_bias else None
    px = torch.from_numpy(x).to(pdt)
    bias = torch.from_numpy(b) if with_bias else None
    w_q, s_w = pq.quantize_weight(torch.from_numpy(w))
    x_q, acc, y = pq.reference_quant_parts(px, w_q, s_w, s_x, bias)

    # codes: exactly eager JAX's (an IEEE division), and the jitted route's
    # wherever dividing and multiplying by the fp32 reciprocal round alike
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jq._quantize_acts(jx, s_x)))
    jit_codes = np.asarray(jax.jit(jq._quantize_acts, static_argnums=1)(jx, s_x))
    sx32 = np.float32(s_x)
    same_tie = (np.round(x / sx32) == np.round(x * (np.float32(1) / sx32)))
    np.testing.assert_array_equal(x_q.numpy()[same_tie], jit_codes[same_tie])
    acc_j = jax.lax.dot_general(jnp.asarray(x_q.numpy()), jw_q, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))

    got = y.numpy()
    jit_ref = np.asarray(jax.jit(jq.reference_quant_dense, static_argnums=3)(
        jx, jw_q, js_w, s_x, jb))
    if shape[0] >= 8:  # the kernel's eligibility: at least one row block
        kernel = np.asarray(jq.quant_dense(jx, jw_q, js_w, s_x, jb, kernel=True, interpret=True))
    else:
        kernel = jit_ref
    rows = same_tie.all(axis=1)
    for want in (jit_ref, kernel):
        assert np.all(np.abs(got - want)[rows] <= _ulp(want)[rows])
    assert not np.array_equal(got, got * 0) and np.isfinite(got).all()

    # |sum(x^ w^ - x w)| <= sum(|x| s_w / 2 + |w| s_x / 2 + s_x s_w / 4)
    full = x @ w + (b if with_bias else 0.0)
    sw = s_w.numpy()
    bound = (0.5 * np.abs(x).sum(1, keepdims=True) * sw[None, :]
             + 0.5 * s_x * np.abs(w).sum(0)[None, :] + w.shape[0] * s_x * sw[None, :] / 4)
    assert np.all(np.abs(got - full) <= bound + 1e-6)


def test_quant_dense_takes_the_plain_version_on_the_cpu():
    x, w, b = _draw((37, 24, 16), "fp32", 2)
    w_q, s_w = pq.quantize_weight(torch.from_numpy(w))
    before = dict(fs.LAUNCHES)
    got = pq.quant_dense(torch.from_numpy(x), w_q, s_w, 0.02, torch.from_numpy(b))
    assert fs.LAUNCHES == before, "the CPU route must not count kernel launches"
    want = pq.reference_quant_dense(torch.from_numpy(x), w_q, s_w, 0.02, torch.from_numpy(b))
    assert torch.equal(got, want)
    parts = pq.quant_dense_parts(torch.from_numpy(x), w_q, s_w, 0.02, torch.from_numpy(b))
    assert torch.equal(parts[2], want) and parts[0].dtype == torch.int8
    # saturation: codes clip at +-127
    assert int(parts[0].abs().max()) == 127


# -- the models ----------------------------------------------------------------


ARCHS = {"gin": four_head_config, "gat": gat_config, "gps": gps_config}


class QuantSetup:
    """Both packages' models from one JAX init, moved parameters and
    running statistics, and three calibration batches."""

    def __init__(self, cfg):
        self.s = Setup(cfg)
        variables = tpu.random_batch_stats(tpu.jitter_params(
            {"params": self.s.jstate.params, "batch_stats": self.s.jstate.batch_stats},
            seed=1), seed=2)
        self.jstate = JaxTrainState(params=variables["params"],
                                    batch_stats=variables["batch_stats"], opt_state=None,
                                    step=jnp.zeros((), jnp.int32))
        self.port = self.s.port_model(variables["params"], variables["batch_stats"])
        self.jbatches = [jax.tree.map(jnp.asarray, b) for b in self.s.batches[:3]]
        self.pbatches = [batch_from_numpy(b) for b in self.s.batches[:3]]

    def jax_tables(self, dtype=jnp.float32):
        scales = jax_collect_scales(self.s.jmodel, self.jstate, self.jbatches, dtype)
        return scales, jax_quantize_dense_weights(self.jstate.params, scales)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def qsetup(request):
    return request.param, QuantSetup(ARCHS[request.param]())


def _real_rows(outputs, batch, kinds):
    gm = np.asarray(batch.graph_mask) > 0
    nm = np.asarray(batch.node_mask) > 0
    return [np.asarray(o, np.float32)[gm if k == "graph" else nm]
            for o, k in zip(outputs, kinds)]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_scale_and_weight_tables_match_jax(qsetup, precision):
    arch, q = qsetup
    jdt, pdt = DTYPES[precision]
    jscales, jweights = q.jax_tables(jdt)
    scales = sq.collect_activation_scales(q.port, q.pbatches, pdt)
    assert {port_module_name(k) for k in jscales} == set(scales)
    assert set(scales) == set(sq.dense_names(q.port).values()), "every Dense calibrated"
    # bf16: layer 0 runs in bf16 on both sides and may round to neighbouring
    # bf16 values (2^-8 relative), which the later layers' maxima carry
    rtol = SCALE_RTOL if precision == "fp32" else 1e-2
    for key, s_j in jscales.items():
        np.testing.assert_allclose(scales[port_module_name(key)], s_j, rtol=rtol, err_msg=key)
    # the weight tables from the same scales: the fp32 masters, exactly
    weights = sq.quantize_dense_weights(q.port, {port_module_name(k): v
                                                 for k, v in jscales.items()})
    assert {port_module_name(k) for k in jweights} == set(weights)
    for key, (jw_q, js_w, jb) in jweights.items():
        w_q, s_w, b = weights[port_module_name(key)]
        np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q), err_msg=key)
        np.testing.assert_array_equal(s_w.numpy(), np.asarray(js_w), err_msg=key)
        assert (b is None) == (jb is None)
        if b is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb), err_msg=key)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_quantized_step_matches_jax(qsetup, precision):
    """The port's and JAX's quantized predict steps from the same scale
    table (JAX's, renamed), each with its own weight table."""
    from hydragnn_tpu.models.base import head_columns

    from hydragnn_tpu.train.step import make_predict_step as jax_make_predict_step

    arch, q = qsetup
    jdt, pdt = DTYPES[precision]
    jscales, jweights = q.jax_tables(jdt)
    scales = {port_module_name(k): v for k, v in jscales.items()}
    step = sq.make_quantized_predict_step(q.port, scales,
                                          sq.quantize_dense_weights(q.port, scales), pdt)
    jstep = jax_make_quant_step(q.s.jmodel, jscales, jweights, jdt)
    kinds = [k for k, _, _ in head_columns(q.s.jmodel.spec)]
    batch = q.s.batches[3]
    jbatch = jax.tree.map(jnp.asarray, batch)
    got = _real_rows([t.numpy() for t in step(batch_from_numpy(batch))], batch, kinds)
    want = _real_rows(jstep(q.jstate, jbatch), batch, kinds)
    unquantized = _real_rows(jax_make_predict_step(q.s.jmodel, jdt)(q.jstate, jbatch), batch,
                             kinds)
    for ihead, (g, w, f) in enumerate(zip(got, want, unquantized)):
        assert np.isfinite(g).all()
        err = float(np.abs(w - f).max())  # the head's int8 error
        if precision == "fp32":
            atol = STEP_ULPS * float(np.spacing(np.float32(np.abs(w).max())))
            assert err > ERR_OVER_TOL * atol, f"{arch} head {ihead}: int8 error {err}"
        else:
            atol = BF16_ATOL + BF16_ERR_SHARE * err
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{arch} head {ihead}")


def test_certified_bounds_match_jax(qsetup):
    """``certify_quant_error`` of each package's own calibration on the same
    batches: per-head bounds within ``BOUND_ATOL`` of each other, and each
    far above it."""
    arch, q = qsetup
    jscales, jweights = q.jax_tables()
    jstep = jax_make_quant_step(q.s.jmodel, jscales, jweights)
    jpred = JaxPredictor(q.s.jmodel, q.jstate, q.s.jaug)
    want = jax_certify_quant_error(jpred, jstep, q.jbatches)
    scales = sq.collect_activation_scales(q.port, q.pbatches)
    step = sq.make_quantized_predict_step(q.port, scales,
                                          sq.quantize_dense_weights(q.port, scales))
    aug = copy.deepcopy(q.s.aug)
    aug["NeuralNetwork"]["Training"]["precision"] = "fp32"
    got = sq.certify_quant_error(Predictor(q.port, aug, device="cpu"), step, q.pbatches)
    assert len(got) == len(want)
    assert all(b > ERR_OVER_TOL * BOUND_ATOL for b in got), (arch, got)
    np.testing.assert_allclose(got, want, rtol=0, atol=BOUND_ATOL, err_msg=arch)


def test_quantized_step_launches_quant_dense_per_dense_call():
    """On the CPU the step takes the plain version for every calibrated
    Dense and counts nothing; each Dense call goes through the interceptor
    once."""
    q = QuantSetup(four_head_config())
    scales = sq.collect_activation_scales(q.port, q.pbatches)
    step = sq.make_quantized_predict_step(q.port, scales,
                                          sq.quantize_dense_weights(q.port, scales))
    calls = []
    orig = pq.quant_dense
    try:
        sq.quant_dense = lambda *a, **k: calls.append(1) or orig(*a, **k)
        before = dict(fs.LAUNCHES)
        step(q.pbatches[0])
        assert fs.LAUNCHES == before
    finally:
        sq.quant_dense = orig
    assert len(calls) == len(scales)


def test_dense_interception_is_local_to_its_context():
    """Unset, ``Dense`` computes what it always did; set on one thread, it
    does not reach another thread's forward."""
    q = QuantSetup(four_head_config())
    from hydragnn_tpu_torch.train.step import make_predict_step

    plain = make_predict_step(q.port)(q.pbatches[0])
    seen = []
    entered, release = threading.Event(), threading.Event()

    def hold(module, x):
        seen.append(module)
        entered.set()
        release.wait(timeout=30)
        return torch.zeros(x.shape[:-1] + (module.weight.shape[0],), dtype=x.dtype)

    def intercepted():
        with intercept_dense(hold):
            make_predict_step(q.port)(q.pbatches[0])

    t = threading.Thread(target=intercepted)
    t.start()
    assert entered.wait(timeout=30)
    try:
        other = make_predict_step(q.port)(q.pbatches[0])  # this thread: no interceptor
    finally:
        release.set()
        t.join(timeout=60)
    for a, b in zip(plain, other):
        assert torch.equal(a, b)
    assert seen, "the interceptor saw the other thread's Dense calls"
    again = make_predict_step(q.port)(q.pbatches[0])
    for a, b in zip(plain, again):
        assert torch.equal(a, b)


# -- the endpoint --------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    q = QuantSetup(four_head_config())
    aug = copy.deepcopy(q.s.aug)
    aug["NeuralNetwork"]["Training"]["precision"] = "fp32"
    return q, aug


def _port_samples(n=60):
    from hydragnn_tpu.datasets import deterministic_graph_data

    return tpu.port_samples(deterministic_graph_data(number_configurations=n, seed=7))


def test_endpoint_serves_int8_answers_of_its_certified_step(served):
    """``quantize=true``: warm-up certifies every bucket within quant_tol;
    served answers equal ``Predictor.outputs(batch, step=<the bucket's int8
    step>)`` bit for bit and lie near the fp32 answers; the fp32 answers of
    the same predictor are unchanged by the int8 half."""
    q, aug = served
    samples = _port_samples()
    server = PredictionServer(ServingConfig(flush_ms=250.0, quantize=True, quant_tol=0.5),
                              device="cpu")
    ep = server.add_model("gin", q.port, aug, samples=samples, batch_size=8, max_buckets=2)
    probe_pad = ep.buckets[-1]
    fp32_before = ep.predictor.outputs(serving_collate(samples[:8], probe_pad))
    report = server.warmup()
    assert "quant" in report["gin"]
    assert len(ep.quant_steps) == len(ep.buckets) and ep.quant_bounds is not None
    assert all(0 < b <= 0.5 for b in ep.quant_bounds)
    fp32_after = ep.predictor.outputs(serving_collate(samples[:8], probe_pad))
    for a, b in zip(fp32_before, fp32_after):
        assert torch.equal(a, b), "the int8 half changed the fp32 answers"
    server.start()
    try:
        futs = [server.submit("gin", s) for s in samples[:24]]
        results = [f.result(timeout=60.0) for f in futs]
        stats = server.stats()["gin"]
    finally:
        server.stop()
    assert stats["quantized"] == len(ep.buckets) and stats["quant_bounds"] == ep.quant_bounds
    by_batch = {}
    for i, r in enumerate(results):
        by_batch.setdefault(r["batch"], []).append((r["slot"], i, r))
    for members in by_batch.values():
        members.sort(key=lambda m: m[0])
        pad = next(b for b in ep.buckets if b.as_tuple() == tuple(members[0][2]["bucket"]))
        chunk = [samples[i] for _, i, _ in members]
        batch = serving_collate(chunk, pad)
        step = ep.quant_steps[pad.as_tuple()]
        want = ep.predictor.split_graphs(ep.predictor.outputs(batch, step=step),
                                         [s.num_nodes for s in chunk])
        ref = ep.predictor.split_graphs(ep.predictor.outputs(batch),
                                        [s.num_nodes for s in chunk])
        for (_, _, r), heads, fp32 in zip(members, want, ref):
            for ihead, (a, b, c) in enumerate(zip(r["heads"], heads, fp32)):
                assert np.array_equal(a, b), "served != outputs(step=int8 step)"
                assert float(np.max(np.abs(a - c))) <= max(3 * ep.quant_bounds[ihead], 0.05)


def test_quantize_needs_warmup_and_validates():
    with pytest.raises(ValueError, match="quantize requires"):
        ServingConfig(quantize=True, warmup=False).validate()
    with pytest.raises(ValueError, match="quant_tol"):
        ServingConfig(quant_tol=0).validate()
    with pytest.raises(ValueError, match="quant_calib_batches"):
        ServingConfig(quant_calib_batches=0).validate()
    with pytest.raises(ValueError, match="quantize requires"):
        PredictionServer({"Serving": {"quantize": True, "warmup": False}}, device="cpu")


def test_quant_tol_gate_never_serves_fp32(served):
    """An unmeetable ``quant_tol`` raises at warm-up and leaves no int8 step;
    ``start()`` runs the int8 warm-up again and raises again."""
    q, aug = served
    samples = _port_samples()
    server = PredictionServer(ServingConfig(quantize=True, quant_tol=1e-9), device="cpu")
    ep = server.add_model("gin", q.port, aug, samples=samples, batch_size=8, max_buckets=2)
    with pytest.raises(QuantizationError, match="quant_tol") as refused:
        server.warmup()
    assert len(refused.value.bounds) == len(ep.predictor.cols)
    assert all(b > 1e-9 for b in refused.value.bounds)
    assert ep.warmed and not ep.quant_steps and ep.quant_bounds is None
    assert server.stats()["gin"]["quantized"] == 0
    with pytest.raises(QuantizationError, match="quant_tol"):
        server.start()
    with pytest.raises(QuantizationError, match="never serves fp32"):
        ep._step_for(ep.buckets[0])


def test_quant_refuses_a_bucket_without_calibration_samples(served):
    q, aug = served
    samples = _port_samples()
    tiny = PadSpec(n_node=8, n_edge=128, n_graph=2, n_triplet=0)
    server = PredictionServer(ServingConfig(quantize=True, quant_tol=10.0), device="cpu")
    server.add_model("gin", q.port, aug, buckets=[tiny], example=samples[0])
    with pytest.raises(QuantizationError, match="no calibration sample") as refused:
        server.warmup()
    assert refused.value.bounds is None
