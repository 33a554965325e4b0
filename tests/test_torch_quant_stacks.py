"""Int8 serving (``serve.quant``) of the port's ten newer stacks (SAGE, MFC,
SchNet, PNA, PNAPlus, CGCNN, PAINN, PNAEq, DimeNet, MACE) and
of the EGNN, PAINN and MACE interatomic potentials, against the JAX
package's ``serve/quant.py`` on the CPU, where ``quant_dense`` takes its
plain version.

The models: each stack on 16 QM9-sized molecules (hidden 16, 3 conv
layers; ``tests/test_torch_invariant_stacks.py`` and
``tests/test_torch_geometric_stacks.py``'s molecule setups; DimeNet's
samples carry their triplets), the MLIPs on four LJ cells
(``tests/test_torch_serve_handoff.py``), from the JAX model's jittered
parameters (and random running statistics where a stack has them).

* The calibrated layers are the JAX package's: the Dense calls that its
  ``collect_activation_scales`` records (every ``nn.Dense.__call__``),
  mapped by ``convert.port_module_name``, and no other (MFC's weight
  banks, the Bessel ``freq``, MACE's irreps linears, element embedding and
  product weights stay fp32 in both). Scales within ``SCALE_RTOL``, the
  fp32 forward tests' rtol of these stacks: a scale is the abs-maximum of
  an fp32 activation, pad rows included as in the reference, that the two
  packages sum in other orders. PNAPlus's scales are held at
  ``STD_SCALE_RTOL``: after its first std, a layer's abs-maximum is the
  dummy pad node's row
  (the last node, which every pad edge reaches), whose std over ~3,500
  equal pad messages is a cancellation of fp32 noise (ROADMAP queue C item
  13; measured up to 3.6e-3 relative, the heads' last Dense; the JAX
  package's jitted and op-by-op scales agree exactly); the int8 weight
  tables equal.
* With the JAX package's scale table, every Dense call's int8 codes in the
  port's quantized step equal those of the JAX quantized step run op by op
  (``jax.disable_jit``, ROADMAP queue C item 9: under ``jit`` XLA
  multiplies by the reciprocal of the scale and moves about one code in a
  million), layer by layer.
* The two quantized steps' answers agree within ``REL`` of each head's
  largest |answer| (with the same codes every int8 layer is exact; the
  rest is fp32 summation order, as in the fp32 forward tests), and each
  head's int8 error is at least ``ERR_OVER_TOL`` times that tolerance, so a
  step that did not quantize fails.
* The quantized step calls ``quant_dense`` (B6's launcher) once per Dense
  call; ``chip_smoke.QUANT_DENSE_CALLS`` holds those counts at the card
  run's configurations, checked here on the CPU route.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import torch_port_util as tpu
from hydragnn_tpu.models.base import head_columns
from hydragnn_tpu.serve import quant as jsq
from hydragnn_tpu.train.step import TrainState as JaxTrainState
from hydragnn_tpu_torch.convert import batch_from_numpy, port_module_name
from hydragnn_tpu_torch.graphs.batching import collate
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.models.common import intercept_dense
from hydragnn_tpu_torch.ops.quant_matmul import quantize_acts
from hydragnn_tpu_torch.serve import quant as sq
from hydragnn_tpu_torch.train.step import make_predict_step

SCALE_RTOL = 2e-5  # tests/test_torch_invariant_stacks.py's fp32 rtol
STD_SCALE_RTOL = {"stack-PNAPlus": 1e-2}
REL = 1e-5  # of the head's largest |answer|
ERR_OVER_TOL = 100.0
INVARIANT = ("SAGE", "MFC", "SchNet", "PNA", "PNAPlus", "CGCNN")
GEOMETRIC = ("PAINN", "PNAEq", "DimeNet", "MACE")
MLIPS = ("EGNN", "PAINN", "MACE")
# the invariant stacks here; the geometric stacks and the MLIPs in
# tests/test_torch_quant_geometric.py, through the same checks (two files,
# so that parallel test workers share the load)
CASES = [f"stack-{s}" for s in INVARIANT]


class QuantCase:
    """Both packages' models of one case and one padded batch (numpy)."""

    def __init__(self, case: str):
        self.case = case
        kind, name = case.split("-", 1)
        if kind == "mlip":
            from test_torch_serve_handoff import MlipSetup

            s = MlipSetup(name, "node")
            self.jaug, self.jmodel, self.nb = s.jaug, s.jmodel, s.nb
            variables, self.port = s.variables, s.model
        else:
            if name in GEOMETRIC:
                from test_torch_geometric_stacks import Setup
            else:
                from test_torch_invariant_stacks import Setup
            s = Setup(name, "molecules")
            self.jaug, self.jmodel, self.nb = s.jaug, s.jmodel, s.batch
            variables, self.port = s.variables, s.port
        self.jstate = JaxTrainState(params=variables["params"],
                                    batch_stats=variables.get("batch_stats", {}),
                                    opt_state=None, step=jnp.zeros((), jnp.int32))
        self.jbatch = jax.tree.map(jnp.asarray, self.nb)
        self.pbatch = batch_from_numpy(self.nb)
        self.kinds = [k for k, _, _ in head_columns(self.jmodel.spec)]

    def real_rows(self, outputs):
        gm = np.asarray(self.nb.graph_mask) > 0
        nm = np.asarray(self.nb.node_mask) > 0
        return [np.asarray(o, np.float32)[gm if k == "graph" else nm]
                for o, k in zip(outputs, self.kinds)]

    def jax_tables(self):
        """The JAX package's scale and int8 weight tables (an eager forward:
        computed once per case)."""
        if not hasattr(self, "_tables"):
            scales = jsq.collect_activation_scales(self.jmodel, self.jstate, [self.jbatch])
            self._tables = scales, jsq.quantize_dense_weights(self.jstate.params, scales)
        return self._tables

    def jax_dense_order(self):
        """The Dense paths of one JAX forward, in call order (recorded while
        ``jax.eval_shape`` traces it)."""
        import flax.linen as nn

        order = []

        def rec(next_fun, args, kwargs, context):
            if isinstance(context.module, nn.Dense) and context.method_name == "__call__":
                order.append("/".join(context.module.path))
            return next_fun(*args, **kwargs)

        jax.eval_shape(lambda st, b: jsq._apply(self.jmodel, st, b, jnp.float32, rec),
                       self.jstate, self.jbatch)
        return order


@pytest.fixture(scope="module", params=CASES)
def qcase(request):
    return QuantCase(request.param)


def test_calibrated_layers_and_weights_equal_jax(qcase):
    calibrated_layers_and_weights_equal_jax(qcase)


def calibrated_layers_and_weights_equal_jax(qcase):
    jscales, jweights = qcase.jax_tables()
    scales = sq.collect_activation_scales(qcase.port, [qcase.pbatch])
    assert {port_module_name(k) for k in jscales} == set(scales)
    assert set(scales) <= set(sq.dense_names(qcase.port).values())
    rtol = STD_SCALE_RTOL.get(qcase.case, SCALE_RTOL)
    for key, s_j in jscales.items():
        np.testing.assert_allclose(scales[port_module_name(key)], s_j, rtol=rtol, err_msg=key)
    weights = sq.quantize_dense_weights(qcase.port, {port_module_name(k): v
                                                     for k, v in jscales.items()})
    assert {port_module_name(k) for k in jweights} == set(weights)
    for key, (jw_q, js_w, jb) in jweights.items():
        w_q, s_w, b = weights[port_module_name(key)]
        np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q), err_msg=key)
        np.testing.assert_array_equal(s_w.numpy(), np.asarray(js_w), err_msg=key)
        assert (b is None) == (jb is None), key
        if b is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb), err_msg=key)


def _port_codes(qcase, step):
    """``{layer: int8 codes}`` of every Dense call of the port's step."""
    names = sq.dense_names(qcase.port)
    codes, inner = {}, step._dense

    def spy(module, x):
        name = names[module]
        codes.setdefault(name, []).append(
            quantize_acts(x.reshape(-1, x.shape[-1]), step.scales[name]).numpy())
        return inner(module, x)

    step._dense = spy
    try:
        out = step(qcase.pbatch)
    finally:
        del step._dense
    return codes, out


def _jax_codes(qcase, jstep):
    """``{layer: int8 codes}`` of every Dense call of the JAX quantized step,
    op by op, in the JAX forward's Dense order."""
    from hydragnn_tpu.ops import quant_matmul as jq

    order, recorded = qcase.jax_dense_order(), []
    inner = jsq.quant_dense

    def spy(x, w_q, s_w, s_x, bias, **kw):
        recorded.append(np.asarray(jq._quantize_acts(x, s_x)))
        return inner(x, w_q, s_w, s_x, bias, **kw)

    jsq.quant_dense = spy
    try:
        with jax.disable_jit():
            out = jstep(qcase.jstate, qcase.jbatch)
    finally:
        jsq.quant_dense = inner
    assert len(recorded) == len(order)
    codes = {}
    for path, c in zip(order, recorded):
        codes.setdefault(port_module_name(path), []).append(c)
    return codes, out


def test_int8_codes_and_answers_equal_eager_jax(qcase):
    codes_and_answers_equal_eager_jax(qcase)


def codes_and_answers_equal_eager_jax(qcase):
    """The same scale table (the JAX package's): every Dense call's codes
    equal, and the answers within ``REL`` of each head while the int8
    error is far above it."""
    jscales, jweights = qcase.jax_tables()
    scales = {port_module_name(k): v for k, v in jscales.items()}
    step = sq.make_quantized_predict_step(qcase.port, scales,
                                          sq.quantize_dense_weights(qcase.port, scales))
    jstep = jsq.make_quantized_predict_step(qcase.jmodel, jscales, jweights)
    codes, out = _port_codes(qcase, step)
    jcodes, jout = _jax_codes(qcase, jstep)
    assert set(codes) == set(jcodes) == set(scales)
    for name in codes:
        assert len(codes[name]) == len(jcodes[name]), name
        for a, b in zip(codes[name], jcodes[name]):
            np.testing.assert_array_equal(a, b, err_msg=name)
    fp32 = qcase.real_rows([t.numpy() for t in make_predict_step(qcase.port)(qcase.pbatch)])
    for ihead, (g, w, f) in enumerate(zip(qcase.real_rows([t.numpy() for t in out]),
                                          qcase.real_rows(jout), fp32)):
        assert np.isfinite(g).all()
        tol = REL * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"head {ihead}")
        err = float(np.abs(g - f).max())
        assert err > ERR_OVER_TOL * tol, f"head {ihead}: int8 error {err} vs tolerance {tol}"


def test_quant_dense_called_once_per_dense_call(qcase, monkeypatch):
    quant_dense_called_once_per_dense_call(qcase, monkeypatch)


def quant_dense_called_once_per_dense_call(qcase, monkeypatch):
    """On the CPU route the quantized step calls ``quant_dense`` (the
    wrapper that launches B6 on the card) once per Dense call of the
    forward, whatever the layer: bias-free, N = 1, 3-D inputs."""
    scales = sq.collect_activation_scales(qcase.port, [qcase.pbatch])
    step = sq.make_quantized_predict_step(qcase.port, scales,
                                          sq.quantize_dense_weights(qcase.port, scales))
    seen = []
    with intercept_dense(lambda m, x: seen.append(m) and None):
        make_predict_step(qcase.port)(qcase.pbatch)
    calls = []
    inner = sq.quant_dense
    monkeypatch.setattr(sq, "quant_dense", lambda *a, **k: calls.append(a[0].dim()) or inner(*a,
                                                                                          **k))
    step(qcase.pbatch)
    assert len(calls) == len(seen) == len(scales) and set(calls) == {2}


def _quant_calls(model, batch, dtype, monkeypatch):
    scales = sq.collect_activation_scales(model, [batch], dtype)
    step = sq.make_quantized_predict_step(model, scales, sq.quantize_dense_weights(model, scales),
                                          dtype)
    calls = []
    inner = sq.quant_dense
    monkeypatch.setattr(sq, "quant_dense", lambda *a, **k: calls.append(1) or inner(*a, **k))
    step(batch)
    return len(calls)


@pytest.mark.parametrize("kind", sorted(cs.ARCH_KNOBS))
def test_chip_smoke_quant_counts_qm9_stacks(kind, monkeypatch):
    """``chip_smoke.QUANT_DENSE_CALLS`` at the card run's qm9 widths (bf16,
    as served): the CPU route's ``quant_dense`` calls per batch."""
    _, aug, loaders, _ = cs.prepare(0, kind, n_samples=40)
    model = create_model_config(aug, device="cpu")
    batch = collate(loaders[0].samples[:8], loaders[0].pad)
    assert _quant_calls(model, batch, torch.bfloat16, monkeypatch) == cs.QUANT_DENSE_CALLS[kind]


@pytest.mark.parametrize("arch", ("EGNN",) + cs.MLIP_ARCHS)
def test_chip_smoke_quant_counts_mlips(arch, monkeypatch):
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = cs.mlip_config(1, arch)
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=cs.mlip_samples(40))
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
    model = create_model_config(aug, device="cpu")
    batch = collate(loaders[0].samples[:4], loaders[0].pad)
    key = "mlip" if arch == "EGNN" else f"mlip-{arch.lower()}"
    assert _quant_calls(model, batch, torch.float32, monkeypatch) == cs.QUANT_DENSE_CALLS[key]


@pytest.mark.parametrize("arch", ("EGNN",) + cs.MLIP_ARCHS)
def test_chip_smoke_mlip_predict_launches(arch, monkeypatch):
    """``chip_smoke.mlip_launches_per_predict`` (a served MLIP batch): the
    CPU route's segment-sum launcher calls of one predict step."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = cs.mlip_config(1, arch)
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=cs.mlip_samples(40))
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
    layers = int(aug["NeuralNetwork"]["Architecture"]["num_conv_layers"])
    model = create_model_config(aug, device="cpu")
    batch = collate(loaders[0].samples[:4], loaders[0].pad)
    counts = dict.fromkeys(cs.KERNELS, 0)
    inner = fs._segment_sum

    def counted(*a, **k):
        counts["segment_sum"] += 1
        return inner(*a, **k)

    monkeypatch.setattr(fs, "_segment_sum", counted)
    make_predict_step(model)(batch)
    assert counts == cs.mlip_launches_per_predict(layers, arch)


def test_chip_smoke_real_rows_name_the_batch_levels():
    """``chip_smoke._real_rows`` (which Dense-input rows of a served batch
    carry answers, for its card-against-CPU code-flip count): nodes,
    edges, graphs, triplets and a flat ``[N, 3, F]`` vector channel by row
    count; an unknown count keeps every row."""
    from conftest import random_molecule_samples
    from hydragnn_tpu_torch.graphs.batching import compute_pad_spec
    from hydragnn_tpu_torch.graphs.triplets import attach_triplets

    samples = tpu.port_samples(random_molecule_samples(6, seed=3))
    for s in samples:
        attach_triplets(s)
    b = collate(samples, compute_pad_spec(samples, 6))
    for rows, mask in ((b.num_nodes, b.node_mask), (b.num_edges, b.edge_mask),
                       (b.num_graphs, b.graph_mask), (b.triplet_mask.numel(), b.triplet_mask),
                       (3 * b.num_nodes, b.node_mask.repeat_interleave(3))):
        assert torch.equal(cs._real_rows(torch, b, rows), mask > 0)
        assert int((mask > 0).sum()) < rows
    other = 3 * b.triplet_mask.numel() + 1
    assert bool(cs._real_rows(torch, b, other).all())
