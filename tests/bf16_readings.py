"""Print the bf16 readings behind the tolerances of the port's bf16 tests,
one JSON line each, on the CPU:

    JAX_PLATFORMS=cpu python tests/bf16_readings.py

* ``envelope``: DimeNet's and PNAPlus's Bessel envelope in bf16, the JAX
  package's against the port's (``integer_pow``) and against the same
  formula with ``torch.pow``'s single rounding of the powers.
* ``forward``: per head of DimeNet (``tests/test_torch_geometric_stacks.py``)
  and PNAPlus (``tests/test_torch_invariant_stacks.py``) on both batches:
  how far the JAX package's jitted bf16 forward lies from its op-by-op
  one (``jax.disable_jit``), the share of its bound the port uses against
  the op-by-op forward (``torch_port_util.assert_within_jax_bf16_gap``),
  the plain GIN bound's share, and for DimeNet the distance, relative to
  the head's largest output, once the port rounds its Dense and ``silu``
  as flax does op by op.
* ``gradients``: per geometric stack, the largest share of its bound
  that the bf16 step's gradients use
  (``tests/test_torch_geometric_train.py``), under the canary's relu and
  under silu.

The tests gate these numbers; this script only reads them.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("HYDRAGNN_AUTO_PARALLEL", "0")
sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import conftest  # noqa: E402,F401  (the tests' JAX settings, before any JAX backend starts)
import numpy as np  # noqa: E402


def envelope() -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from hydragnn_tpu.models import radial as jrad
    from hydragnn_tpu_torch.models import radial as prad

    x = np.random.default_rng(0).uniform(0.0, 1.2, 4096).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jax.jit(lambda a: jrad.polynomial_envelope(a, 5))(
        jnp.asarray(x, jnp.bfloat16)), np.float32)
    p = 6
    one_rounding = (1.0 / torch.where(xt == 0, torch.ones_like(xt), xt)
                    - 28.0 * xt ** (p - 1) + 48.0 * xt ** p - 21.0 * xt ** (p + 1))
    one_rounding = torch.where(xt < 1.0, one_rounding, torch.zeros_like(one_rounding))
    out = {}
    for name, got in (("integer_pow", prad.polynomial_envelope(xt, 5)),
                      ("torch.pow", one_rounding)):
        got = got.float().numpy()
        out[name] = {"differ": float(np.mean(got != want)),
                     "max_abs": float(np.abs(got - want).max())}
    return out


def _gin_share(got, want) -> float:
    return float((np.abs(got - want) / (2e-2 + 2e-2 * np.abs(want))).max())


def forward(stack: str, data: str) -> list:
    import jax
    import jax.numpy as jnp
    import pytest
    import torch

    os.environ["HYDRAGNN_FUSED_SCATTER"] = "0"
    if stack == "PNAPlus":
        import test_torch_invariant_stacks as inv
        from hydragnn_tpu.models.base import head_columns
        from hydragnn_tpu_torch.convert import batch_from_numpy
        from hydragnn_tpu_torch.train.step import make_predict_step

        st = inv.Setup(stack, data)
        cols = head_columns(st.jmodel.spec)

        def jf(precision):
            dtype = jnp.float32 if precision == "fp32" else jnp.bfloat16
            return inv._real_rows(inv.jax_predict(st, dtype), st.batch, cols)

        def pf(precision):
            dtype = torch.float32 if precision == "fp32" else torch.bfloat16
            out = make_predict_step(st.port, dtype)(batch_from_numpy(st.batch))
            return inv._real_rows([t.numpy() for t in out], st.batch, cols)
    else:
        import test_torch_geometric_stacks as geo

        st = geo.Setup(stack, data)
        jf, pf = st.jax_forward, st.port_forward
    jit16 = jf("bf16")
    with jax.disable_jit():
        w16, w32 = jf("bf16"), jf("fp32")
    got = pf("bf16")
    emulated = None
    if stack == "DimeNet":
        mp = pytest.MonkeyPatch()
        with geo._flax_rounding(mp):
            emulated = pf("bf16")
        mp.undo()
    rows = []
    for ihead, (g, w, w32_, wj) in enumerate(zip(got, w16, w32, jit16)):
        row = {"stack": stack, "data": data, "head": ihead,
               "max_abs_output": float(np.abs(w).max()),
               "jax_jit_vs_op_by_op": float(np.abs(wj - w).max()),
               "share_of_bound": float((np.abs(g - w) / (2e-2 + 2e-2 * np.abs(w)
                                                         + np.abs(w - w32_))).max()),
               "gin_share_op_by_op": _gin_share(g, w), "gin_share_jit": _gin_share(g, wj)}
        if emulated is not None:
            row["emulated_rel"] = float(np.abs(emulated[ihead] - w).max() / np.abs(w).max())
        rows.append(row)
    return rows


def gradients(stack: str, activation: str) -> dict:
    import jax.numpy as jnp
    import torch

    import test_torch_geometric_train as tr

    os.environ["HYDRAGNN_FUSED_SCATTER"] = "1"
    cfg = tr.stack_config(stack)
    cfg["NeuralNetwork"]["Architecture"]["activation_function"] = activation
    st = tr.Setup(cfg)
    batch = st.batches[0]
    _, _, want, _ = tr._jax_grads(st, batch, jnp.bfloat16)
    _, _, want32, _ = tr._jax_grads(st, batch)
    _, _, got = tr._port_grads(st.port_model(), batch, torch.bfloat16)
    share = {n: float((np.abs(got[n] - want[n])
                       / (2e-3 + 2e-2 * np.abs(want[n]) + np.abs(want[n] - want32[n]))).max())
             for n in got}
    worst = max(share, key=share.get)
    return {"stack": stack, "activation": activation, "max_share": share[worst],
            "tensor": worst}


def main() -> None:
    print(json.dumps({"envelope": envelope()}), flush=True)
    for stack in ("DimeNet", "PNAPlus"):
        for data in ("four_heads", "molecules"):
            for row in forward(stack, data):
                print(json.dumps({"forward": row}), flush=True)
    for stack in ("PAINN", "PNAEq", "DimeNet", "MACE"):
        for activation in ("relu", "silu"):
            print(json.dumps({"gradients": gradients(stack, activation)}), flush=True)


if __name__ == "__main__":
    main()
