"""Edge features in the port (``Dataset.compute_edge_lengths``,
``Architecture.edge_features``) against the JAX package, on the CPU: the
ten ``EDGE_MODELS`` stacks' forward and every parameter gradient, fp32 and
bf16, from the same parameters; MACE's outputs unchanged by edge
features; and an endpoint whose requests carry edge features.

The model is each stack on the tier-1 canary configuration
(``tests/test_config.py`` ``CI_CONFIG``: hidden 8, 2 conv layers; the
stack's ``ARCH_OVERRIDES``) with the edge lengths as its one edge feature,
dropout 0 (both packages then compute the same function in train mode) and
``silu`` for relu (under relu a pre-activation within bf16 noise of 0 takes
the other branch in one package only), on the first of the JAX loader's
batches of 8 BCC graphs. The parameters are the port's initial draw,
jittered and written into the JAX model's variables
(``torch_port_util.flax_variables_from_port``), then carried back into a
fresh port model by ``convert.load_jax_variables``.

Tolerances, with their reasons:

* fp32 forward: rtol 2e-5 / atol 1e-5, the invariant stacks': XLA and
  PyTorch sum in other orders. fp32 gradients: the GIN's rtol 1e-4 / atol
  1e-6, PNA, PNAPlus and PNAEq at atol 1e-5 (their std amplifies fp32
  rounding, ROADMAP queue C item 13).
* bf16 forward: the GIN's rtol / atol 2e-2 (GAT 3e-2: the reference sums
  its 3-D aggregation in bf16, queue C item 5), plus, per entry, the JAX
  package's own bf16 distance from its fp32 forward for PNAPlus and
  DimeNet (XLA's fusions, item 14) and PAINN, PNAEq and MACE (their 3-D
  sums, item 15). bf16 gradients: the GIN's rtol 2e-2 / atol 2e-3 plus the
  JAX step's own distance from its fp32 gradient, per entry; GAT's at its
  forward's 3e-2 (item 5 again: layer 1's ``lin_l`` gradient sums the bf16
  aggregation's cotangents, and misses the GIN's bound by 2.5e-3).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jax_loading
from hydragnn_tpu_torch.config.schema import EDGE_MODELS
from hydragnn_tpu_torch.convert import load_jax_variables
from test_config import CI_CONFIG
from test_training_e2e import ARCH_OVERRIDES

FWD_TOL = dict(rtol=2e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STD_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STD_STACKS = {"PNA", "PNAPlus", "PNAEq"}
BF16_FWD_TOL = {"GAT": dict(rtol=3e-2, atol=3e-2)}
BF16_GRAD_TOL = {"GAT": dict(rtol=3e-2, atol=3e-2)}
BF16_GAP_STACKS = {"PNAPlus", "DimeNet", "PAINN", "PNAEq", "MACE"}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def stack_config(stack: str, edge: bool = True, gps: str | None = None,
                 **arch_overrides) -> dict:
    """``CI_CONFIG`` on ``stack`` with its ``ARCH_OVERRIDES``, dropout 0 and
    silu; ``edge``: the edge lengths as the one edge feature; ``gps``: GPS
    with that attention type (2 heads, ``pe_dim`` 2)."""
    cfg = copy.deepcopy(CI_CONFIG)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(mpnn_type=stack, **ARCH_OVERRIDES.get(stack, {}), dropout=0.0,
                activation_function="silu")
    if edge:
        cfg["Dataset"]["compute_edge_lengths"] = True
        arch["edge_features"] = ["length"]
    if gps:
        arch.update(global_attn_engine="GPS", global_attn_type=gps, global_attn_heads=2,
                    pe_dim=2)
    arch.update(arch_overrides)
    cfg["NeuralNetwork"]["Training"]["batch_size"] = 8
    return cfg


class Setup:
    """One configuration in both packages: the loaders built by each from
    copies of the same samples, the JAX model, the shared variables and
    the first JAX train batch. References are computed once per dtype;
    ``eval_outputs``: the JAX reference also runs the eval-mode forward
    (else the forward checks read the train-mode outputs)."""

    def __init__(self, cfg: dict, n_samples: int = 24, eval_outputs: bool = True):
        from hydragnn_tpu_torch.config import update_config
        from hydragnn_tpu_torch.models import create_model_config
        from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

        samples = deterministic_graph_data(number_configurations=n_samples, seed=7)
        jl = jax_loading(copy.deepcopy(cfg), samples=tpu.jax_samples_copy(samples))
        self.loaders = dataset_loading_and_splitting(copy.deepcopy(cfg),
                                                     samples=tpu.port_samples(samples))
        self.cfg = cfg
        self.eval_outputs = eval_outputs
        self._refs: dict = {}
        self.jaug = jax_update_config(copy.deepcopy(cfg), *(ld.samples for ld in jl))
        self.aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in self.loaders))
        self.jmodel = jax_create_model_config(self.jaug)
        self.batch = next(iter(jl[0]))
        first = create_model_config(copy.deepcopy(self.aug), device="cpu", seed=0)
        self.spec = first.spec
        self.variables = tpu.flax_variables_from_port(first, self.jmodel, self.batch,
                                                      jitter_seed=1)
        self.performer = (self.spec.global_attn_engine == "GPS"
                          and self.spec.global_attn_type == "performer")

    def projections(self, precision: str):
        if not self.performer:
            return None
        return tpu.performer_projections(self.jmodel, self.batch, self.variables,
                                         DTYPES[precision][0])

    def port_model(self, precision: str = "fp32"):
        """A fresh port model (other random draws) holding the shared
        variables, carried across by ``convert.load_jax_variables``."""
        from hydragnn_tpu_torch.models import create_model_config

        model = create_model_config(copy.deepcopy(self.aug), device="cpu", seed=1)
        return load_jax_variables(model, self.variables["params"],
                                  self.variables["batch_stats"], self.projections(precision))

    def jax(self, precision: str) -> dict:
        key = ("jax", precision)
        if key not in self._refs:
            self._refs[key] = tpu.jax_reference(self.jmodel, self.variables, self.batch,
                                                DTYPES[precision][0],
                                                eval_outputs=self.eval_outputs)
        return self._refs[key]

    def port(self, precision: str) -> dict:
        key = ("port", precision)
        if key not in self._refs:
            self._refs[key] = tpu.port_reference(self.port_model(precision), self.batch,
                                                 DTYPES[precision][1])
        return self._refs[key]


def check_forward(setup: Setup, precision: str, stack: str) -> None:
    key = "outputs" if setup.eval_outputs else "train_outputs"
    got = tpu.real_rows(setup.port(precision)[key], setup.batch, setup.spec)
    want = tpu.real_rows(setup.jax(precision)[key], setup.batch, setup.spec)
    assert all(np.isfinite(g).all() for g in got)
    if precision == "fp32":
        for ihead, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, **FWD_TOL, err_msg=f"head {ihead}")
        return
    tol = BF16_FWD_TOL.get(stack, dict(rtol=2e-2, atol=2e-2))
    if stack in BF16_GAP_STACKS:
        want32 = tpu.real_rows(setup.jax("fp32")[key], setup.batch, setup.spec)
        for ihead, (g, w, w32) in enumerate(zip(got, want, want32)):
            tpu.assert_within_jax_bf16_gap(g, w, w32, **tol, what=f"head {ihead}")
        return
    for ihead, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **tol, err_msg=f"head {ihead}")


def check_gradients(setup: Setup, precision: str, stack: str) -> None:
    p, j = setup.port(precision), setup.jax(precision)
    assert set(p["grads"]) == set(j["grads"])
    if precision == "fp32":
        tol = STD_GRAD_TOL if stack in STD_STACKS else GRAD_TOL
        np.testing.assert_allclose(p["loss"], j["loss"], **tol)
        np.testing.assert_allclose(p["tasks"], j["tasks"], **tol)
        for name, g in p["grads"].items():
            np.testing.assert_allclose(g, j["grads"][name], **tol, err_msg=name)
        for name, v in j["stats"].items():
            np.testing.assert_allclose(p["stats"][name], v, **tol, err_msg=name)
        return
    j32 = setup.jax("fp32")
    tol = BF16_GRAD_TOL.get(stack, dict(rtol=2e-2, atol=2e-3))
    np.testing.assert_allclose(p["loss"], j["loss"], **tol)
    for name, g in p["grads"].items():
        tpu.assert_within_jax_bf16_gap(g, j["grads"][name], j32["grads"][name], **tol,
                                       what=name)


@pytest.fixture(scope="module", params=EDGE_MODELS)
def setup(request):
    s = Setup(stack_config(request.param))
    assert s.spec.edge_dim == 1 and s.batch.edge_attr.shape[1] == 1
    return s


@pytest.mark.parametrize("precision", sorted(DTYPES))
def test_forward_matches_jax(setup, precision):
    check_forward(setup, precision, setup.spec.mpnn_type)


@pytest.mark.parametrize("precision", sorted(DTYPES))
def test_gradients_match_jax(setup, precision):
    """Loss, per-task losses, every parameter's gradient (the edge
    branches' included) and the updated running statistics of one
    train-mode forward and backward."""
    check_gradients(setup, precision, setup.spec.mpnn_type)
    grads = setup.port(precision)["grads"]
    edge_params = [n for n in grads if any(k in n for k in (
        "lin_edge", "edge_filter", "edge_encoder"))]
    stack = setup.spec.mpnn_type
    if stack in ("GAT", "PAINN", "PNAEq", "PNAPlus"):
        assert edge_params and any(np.abs(grads[n]).max() > 0 for n in edge_params), stack


def test_mace_outputs_ignore_edge_features():
    """MACE accepts edge features and reads none: the same variables in
    a model without them give the same outputs, bit for bit, whatever the
    batch's ``edge_attr`` holds."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.convert import batch_from_numpy
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.step import make_predict_step

    s = Setup(stack_config("MACE"), n_samples=16)
    plain_aug = update_config(copy.deepcopy(stack_config("MACE", edge=False)),
                              *(ld.samples for ld in s.loaders))
    plain = load_jax_variables(create_model_config(plain_aug, device="cpu", seed=2),
                               s.variables["params"], s.variables["batch_stats"])
    with_edges = s.port_model()
    assert with_edges.spec.edge_dim == 1 and plain.spec.edge_dim == 0
    pb = batch_from_numpy(s.batch)
    noisy = pb.replace(edge_attr=torch.randn(pb.edge_attr.shape,
                                             generator=torch.Generator().manual_seed(0)))
    want = make_predict_step(plain)(pb)
    for b in (pb, noisy):
        for g, w in zip(make_predict_step(with_edges)(b), want):
            assert torch.equal(g, w)


def test_edge_feature_endpoint_serves_and_sheds():
    """A GAT endpoint whose requests carry the edge lengths: served answers
    equal ``Predictor.outputs`` on the same padded batch, and a request
    whose ``edge_attr`` has another width is shed at admission, typed."""
    from hydragnn_tpu_torch.serve import (IncompatibleSampleError, PredictionServer,
                                          Predictor, ServingConfig)
    from hydragnn_tpu_torch.serve.batcher import serving_collate

    s = Setup(stack_config("GAT"), n_samples=16)
    samples = s.loaders[0].samples
    model = s.port_model()
    server = PredictionServer(ServingConfig(flush_ms=250.0), device="cpu")
    ep = server.add_model("gat_edge", model, s.aug, samples=samples, buckets=[s.loaders[0].pad])
    server.start()
    try:
        wide = copy.deepcopy(samples[0])
        wide.edge_attr = np.concatenate([wide.edge_attr, wide.edge_attr], axis=1)
        with pytest.raises(IncompatibleSampleError, match="edge_attr_width"):
            server.submit("gat_edge", wide)
        chunk = samples[:4]
        results = [f.result(timeout=60.0) for f in
                   [server.submit("gat_edge", x) for x in chunk]]
        stats = server.stats()["gat_edge"]
    finally:
        server.stop()
    assert stats["shed"] == 1 and stats["failed"] == 0 and stats["served"] == 4
    # each served batch recollated as the server collated it
    predictor = Predictor(model, s.aug, device="cpu")
    by_batch: dict = {}
    for i, r in enumerate(results):
        by_batch.setdefault(r["batch"], []).append((r["slot"], i, r))
    for members in by_batch.values():
        members.sort(key=lambda m: m[0])
        batch_samples = [chunk[i] for _, i, _ in members]
        out = predictor.outputs(serving_collate(batch_samples, ep.buckets[0]))
        per_graph = predictor.split_graphs(out, [x.num_nodes for x in batch_samples])
        for (_, _, r), heads in zip(members, per_graph):
            for served, want in zip(r["heads"], heads):
                assert np.array_equal(np.asarray(served), np.asarray(want))
