"""Int8 serving of the geometric stacks PAINN, PNAEq, DimeNet and MACE and
of the EGNN, PAINN and MACE interatomic potentials, against the JAX
package on the CPU: the checks of ``tests/test_torch_quant_stacks.py``
(which holds the invariant stacks and states the tolerances), on these
models."""

import pytest

import test_torch_quant_stacks as qs

CASES = [f"stack-{s}" for s in qs.GEOMETRIC] + [f"mlip-{a}" for a in qs.MLIPS]


@pytest.fixture(scope="module", params=CASES)
def qcase(request):
    return qs.QuantCase(request.param)


def test_calibrated_layers_and_weights_equal_jax(qcase):
    qs.calibrated_layers_and_weights_equal_jax(qcase)


def test_int8_codes_and_answers_equal_eager_jax(qcase):
    qs.codes_and_answers_equal_eager_jax(qcase)


def test_quant_dense_called_once_per_dense_call(qcase, monkeypatch):
    qs.quant_dense_called_once_per_dense_call(qcase, monkeypatch)
