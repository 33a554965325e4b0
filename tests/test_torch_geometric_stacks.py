"""The geometric conv stacks PAINN, PNAEq, DimeNet and MACE of the port
against the JAX package's, the flax variables (parameters jittered) loaded
into the port by ``convert.load_jax_variables``.

Two batches per stack, as ``tests/test_torch_invariant_stacks.py`` holds
the invariant stacks: the 4-head BCC canary of
``tests/test_training_e2e.py`` (64 graphs; hidden 8, 2 conv layers, the
stack's ``ARCH_OVERRIDES``) and 16 QM9-sized molecules (hidden 16, 3 conv
layers); DimeNet's samples carry their triplets. The JAX side runs with its
fused-scatter flag off (XLA) and on (its Pallas kernels in interpret mode).

Tolerances, with their reasons:

* fp32 forward: per head, max |port - JAX| within 1e-5 of the head's
  largest |output| (XLA and PyTorch sum in other orders). Measured: at
  most 2.3e-6 of it (DimeNet, whose outputs reach ~56 here: its sums
  cancel, so a small entry may differ by 2.4e-4 of itself, beyond the
  GIN's per-entry rtol 2e-5).
* The bf16 predict step: the GIN's rtol 2e-2 / atol 2e-2 for PAINN, PNAEq
  and MACE (measured, at most 0.65 of it: PNAEq's node heads). DimeNet's
  bf16 forward misses its own fp32 forward by up to 14% of the output (8.1
  on outputs of ~56, the molecules): its radial and spherical bases
  evaluate a polynomial envelope whose terms of ``1/x`` and up to ``48
  x^6`` cancel in bf16 (1 bf16 ulp of 48 is 0.25), and 3 layers without a
  norm carry that through. There a rounding that differs by one ulp moves
  an output far, so the reference is the JAX package's bf16 forward
  evaluated op by op (``jax.disable_jit``), each op rounded to bf16 as the
  port rounds it: its jitted forward departs from that by up to 6.9 on
  outputs of 62.6, since XLA fuses elementwise chains. DimeNet's bf16
  step is held per entry to the GIN's bound plus the JAX package's own
  op-by-op distance from its fp32 forward on that entry (the form of
  ``tests/test_torch_invariant_train.py``'s bf16 gradients). Measured
  (``tests/bf16_readings.py``), it uses at most 0.75 of that bound, and
  the plain GIN bound alone fails (1.9 of it, the 4-head batch).
  ``integer_pow`` made this hold: ``torch.pow`` rounded the envelope's
  powers once where ``jnp``'s ``x ** n`` rounds each product (ROADMAP
  queue C item 14).
* ``test_dimenet_bf16_is_the_reference_rounding``: with the two remaining
  roundings of flax's op-by-op forward emulated in the port (a Dense adds
  its bias after the product is rounded; ``silu`` as ``x * (1 / (1 +
  exp(-x)))``, each op rounded), DimeNet's bf16 forward equals the JAX
  package's op-by-op forward within the fp32 forward's 1e-5 of the head's
  largest output (measured, at most 1.2e-6, ``tests/bf16_readings.py``):
  the two packages then differ only where they sum in other orders.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from conftest import random_molecule_samples
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.graphs.batching import collate, compute_pad_spec
from hydragnn_tpu.graphs.triplets import attach_triplets
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models.base import head_columns
from hydragnn_tpu.models.create import init_model
from hydragnn_tpu.preprocess import apply_variables_of_interest
from hydragnn_tpu.train.step import TrainState
from hydragnn_tpu.train.step import make_predict_step as jax_make_predict_step
from hydragnn_tpu_torch.convert import batch_from_numpy, load_jax_variables
from hydragnn_tpu_torch.train.step import make_predict_step as port_make_predict_step
from __graft_entry__ import FLAGSHIP_CONFIG
from test_training_e2e import ARCH_OVERRIDES

STACKS = ("PAINN", "PNAEq", "DimeNet", "MACE")
FP32_REL = 1e-5  # of the head's largest |output|
BF16 = dict(rtol=2e-2, atol=2e-2)  # the GIN's


def four_head_config(stack):
    cfg = copy.deepcopy(FLAGSHIP_CONFIG)
    arch = cfg["NeuralNetwork"]["Architecture"]
    cfg["NeuralNetwork"]["Variables_of_interest"] = {
        "input_node_features": [0],
        "output_names": ["sum", "x", "x2", "x3"],
        "output_index": [0, 1, 2, 3],
        "type": ["graph", "node", "node", "node"],
        "denormalize_output": False,
    }
    arch.update(mpnn_type=stack, hidden_dim=8, num_conv_layers=2,
                task_weights=[20.0, 1.0, 1.0, 1.0])
    arch.update(ARCH_OVERRIDES[stack])
    arch["output_heads"]["graph"]["dim_sharedlayers"] = 10
    arch["output_heads"]["node"] = {"num_headlayers": 2, "dim_headlayers": [10, 10],
                                    "type": "mlp"}
    return cfg


def molecule_config(stack):
    cfg = copy.deepcopy(FLAGSHIP_CONFIG)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(mpnn_type=stack, num_conv_layers=3)
    arch.update(ARCH_OVERRIDES[stack])
    arch["hidden_dim"] = 16
    arch["output_heads"]["graph"].update(dim_sharedlayers=8, dim_headlayers=[16, 16])
    arch["output_heads"]["node"].update(dim_headlayers=[16, 16])
    return cfg


DATA = {
    "four_heads": lambda stack: (four_head_config(stack),
                                 deterministic_graph_data(number_configurations=64, seed=7), 64),
    "molecules": lambda stack: (molecule_config(stack), random_molecule_samples(16, seed=21),
                                16),
}


class Setup:
    """Both packages' models of one stack from one JAX init (jittered), and
    the collated batch."""

    def __init__(self, stack, data):
        from hydragnn_tpu_torch.config import update_config

        cfg, samples, bs = DATA[data](stack)
        samples = apply_variables_of_interest(samples, cfg)
        if stack == "DimeNet":
            for s in samples:
                attach_triplets(s)
        self.stack = stack
        self.jaug = jax_update_config(copy.deepcopy(cfg), samples)
        self.aug = update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
        self.jmodel = jax_create_model_config(self.jaug)
        self.batch = collate(samples[:bs], compute_pad_spec(samples, bs))
        assert self.batch.x.shape[0] >= 256, "the JAX kernel path needs >= 256 node slots"
        self.variables = tpu.jitter_params(init_model(self.jmodel, self.batch), seed=1)
        self.port = tpu.port_model_from_jax(self.aug, self.variables)
        self.cols = head_columns(self.jmodel.spec)

    def real_rows(self, outputs):
        gm = np.asarray(self.batch.graph_mask) > 0
        nm = np.asarray(self.batch.node_mask) > 0
        return [np.asarray(o, np.float32)[gm if kind == "graph" else nm]
                for o, (kind, _, _) in zip(outputs, self.cols)]

    def jax_forward(self, precision):
        v = self.variables
        state = TrainState(params=v["params"], batch_stats=v.get("batch_stats", {}),
                           opt_state=None, step=jnp.zeros((), jnp.int32))
        dtype = jnp.float32 if precision == "fp32" else jnp.bfloat16
        out = jax_make_predict_step(self.jmodel, dtype)(state, jax.tree.map(jnp.asarray,
                                                                              self.batch))
        return self.real_rows(out)

    def port_forward(self, precision):
        dtype = torch.float32 if precision == "fp32" else torch.bfloat16
        out = port_make_predict_step(self.port, dtype)(batch_from_numpy(self.batch))
        return self.real_rows([t.numpy() for t in out])


@pytest.fixture(scope="module", params=[(s, d) for s in STACKS for d in sorted(DATA)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def setup(request):
    return Setup(*request.param)


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_matches_jax(setup, monkeypatch, fused, precision):
    monkeypatch.setenv("HYDRAGNN_FUSED_SCATTER", fused)
    got = setup.port_forward(precision)
    if precision == "bf16" and setup.stack == "DimeNet":
        # against the JAX forward op by op, at the GIN's bound plus its own
        # bf16 distance from fp32 (module docstring)
        with jax.disable_jit():
            want, want32 = setup.jax_forward("bf16"), setup.jax_forward("fp32")
        for ihead, (g, w, w32) in enumerate(zip(got, want, want32)):
            assert np.isfinite(g).all()
            tpu.assert_within_jax_bf16_gap(g, w, w32, **BF16, what=f"head {ihead}")
        return
    want = setup.jax_forward(precision)
    for ihead, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g).all()
        if precision == "fp32":
            err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
            assert err <= FP32_REL * scale, f"head {ihead}: {err:.3e} of {scale:.3e}"
        else:
            np.testing.assert_allclose(g, w, **BF16, err_msg=f"head {ihead}")



def _flax_rounding(monkeypatch):
    """The port's Dense and ``silu`` rounded op by op as flax's are: the
    bias added to the rounded product, ``silu`` as ``x * (1 / (1 +
    exp(-x)))``."""
    import torch.nn.functional as F
    from hydragnn_tpu_torch.models.common import intercept_dense

    def dense(mod, x):
        dtype = torch.promote_types(x.dtype, mod.weight.dtype)
        y = F.linear(x.to(dtype), mod.weight.to(dtype))
        return y if mod.bias is None else y + mod.bias.to(dtype)

    monkeypatch.setattr(F, "silu", lambda x: x * (1 / (1 + torch.exp(-x))))
    return intercept_dense(dense)


@pytest.mark.parametrize("data", sorted(DATA))
def test_dimenet_bf16_is_the_reference_rounding(data, monkeypatch):
    """DimeNet's bf16 predict step is the JAX package's op-by-op bf16
    forward once the port rounds its Dense and ``silu`` as flax does: every
    basis, cast, promotion and sum of the path (the envelope's powers, the
    spherical basis, the triplet mixing, the output sum) rounds as the
    reference's, within ``FP32_REL`` of each head's largest output."""
    monkeypatch.setenv("HYDRAGNN_FUSED_SCATTER", "0")
    st = Setup("DimeNet", data)
    with jax.disable_jit():
        want = st.jax_forward("bf16")
    with _flax_rounding(monkeypatch):
        got = st.port_forward("bf16")
    for ihead, (g, w) in enumerate(zip(got, want)):
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= FP32_REL * scale, f"head {ihead}: {err:.3e} of {scale:.3e}"

def test_load_jax_variables_is_complete_and_strict(setup):
    """Every port parameter has its flax variable (MACE's irreps linears
    ``w{l}``/``b0``, its element embedding and ``prod_w*``, DimeNet's
    interaction block, the Bessel frequencies); a missing, an extra or a
    misshapen one raises."""
    params = tpu.numpy_tree(setup.variables["params"])
    names = set(dict(setup.port.named_parameters()))
    assert not any(n.startswith("feature_layers") for n in names), "no feature norm"
    missing = copy.deepcopy(params)
    conv0 = missing["graph_convs_0"]
    del conv0[sorted(conv0)[0]]
    with pytest.raises(KeyError, match="without a flax variable"):
        load_jax_variables(setup.port, missing, {})
    extra = copy.deepcopy(params)
    extra["graph_convs_0"]["bogus"] = np.zeros(())
    with pytest.raises(KeyError):
        load_jax_variables(setup.port, extra, {})
    wrong = copy.deepcopy(params)
    leaf = wrong["graph_convs_0"]
    while isinstance(leaf[sorted(leaf)[0]], dict):
        leaf = leaf[sorted(leaf)[0]]
    key = sorted(leaf)[0]
    leaf[key] = np.zeros(np.shape(leaf[key]) + (2,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(setup.port, wrong, {})
    load_jax_variables(setup.port, params, {})  # leave the shared fixture intact


@pytest.mark.parametrize("stack", ["PNAPlus", "PNAEq", "DimeNet", "MACE"])
def test_bf16_gap_is_the_formulas(stack):
    """ROADMAP queue C item 14: both packages' bf16 forwards held against
    their fp32 forwards on the same batch (16 molecules), the stacks with
    DimeNet's Bessel basis and envelope. The port's bf16 forward misses
    fp32 by no more than the JAX package's own bf16 forward does (x 1.25,
    plus the GIN's 2e-2): what separates the packages in bf16 is the
    formula's rounding, which both take. PNAPlus, whose gap item 14
    recorded (2.8e-2 between the packages), misses fp32 by more than the
    GIN's whole bound in the JAX package itself."""
    if stack == "PNAPlus":
        import test_torch_invariant_stacks as inv

        st = inv.Setup(stack, "molecules")
        cols = head_columns(st.jmodel.spec)

        def jf(p):
            out = inv.jax_predict(st, jnp.float32 if p == "fp32" else jnp.bfloat16)
            return inv._real_rows(out, st.batch, cols)

        def pf(p):
            out = port_make_predict_step(st.port, torch.float32 if p == "fp32" else
                                         torch.bfloat16)(batch_from_numpy(st.batch))
            return inv._real_rows([t.numpy() for t in out], st.batch, cols)
    else:
        st = Setup(stack, "molecules")
        jf, pf = st.jax_forward, st.port_forward
    j32, j16, p32, p16 = jf("fp32"), jf("bf16"), pf("fp32"), pf("bf16")
    for ihead in range(len(j32)):
        jax_gap = float(np.abs(j16[ihead] - j32[ihead]).max())
        port_gap = float(np.abs(p16[ihead] - p32[ihead]).max())
        assert port_gap <= 1.25 * jax_gap + 2e-2, (ihead, port_gap, jax_gap)
    if stack == "PNAPlus":
        assert float(np.abs(j16[-1] - j32[-1]).max()) > 2e-2
