"""Int8 inference quantization for the serving tier.

Counterpart of ``hydragnn_tpu/serve/quant.py``, with the same contracts,
keyed by the port's module names (``graph_convs.0.nn.dense_0``;
``convert.port_module_name`` maps the JAX package's paths onto them):

- **calibration** (:func:`collect_activation_scales`): forward passes over
  per-bucket calibration batches that record every ``Dense`` input's
  abs-max (of the compute-dtype input, in fp32): one activation scale
  ``max(absmax, 1e-8) / 127`` per layer, as a Python float;
- **weight quantization** (:func:`quantize_dense_weights`): symmetric
  per-output-channel int8 of every calibrated Dense's fp32 weight (the
  master parameters, not their compute-dtype cast), as ``w_q [in, out]``;
  the bias stays fp32, every other parameter stays in the model;
- **the quantized step** (:class:`QuantizedPredictStep`): the fp32 predict
  step's ``cast_forward`` with every calibrated Dense computed by
  ``ops.quant_matmul.quant_dense`` (the kernel on the card), its input
  reshaped to 2-D and its output cast back to the input's dtype;
- **error certification** (:func:`certify_quant_error`): per-head max abs
  deviation of the int8 answers from the fp32 answers on the calibration
  batches' real rows. The endpoint refuses to serve int8 when a head's
  bound exceeds ``Serving.quant_tol`` (:class:`QuantizationError`).

The interception is ``models.common.intercept_dense``, a context variable
that ``Dense.forward`` reads: the fp32 predict step and every other thread
see the model unchanged, bit for bit. The quantized step can be captured in
a CUDA graph (``capture.py``): the scales are Python floats fixed per step,
and B6's opt-in to more than 48 KB of dynamic shared memory, which its
launcher makes at a device's first launch, happens in the eager warm-up
runs that precede every capture.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..models.common import Dense, intercept_dense
from ..ops.quant_matmul import quant_dense, quantize_weight
from ..train.step import cast_forward


class QuantizationError(RuntimeError):
    """A head's calibrated int8 error exceeds ``Serving.quant_tol`` (then
    ``bounds`` holds the measured per-head bounds), or a bucket has no
    calibration sample (``bounds`` is None)."""

    def __init__(self, message: str, bounds: list[float] | None = None):
        super().__init__(message)
        self.bounds = bounds


def dense_names(model: torch.nn.Module) -> dict:
    """``{Dense module: its name in model.named_modules()}``."""
    return {m: name for name, m in model.named_modules() if isinstance(m, Dense)}


def collect_activation_scales(model: torch.nn.Module, batches: Sequence,
                              compute_dtype: torch.dtype = torch.float32) -> dict[str, float]:
    """Per-``Dense`` activation scales (abs-max / 127) observed over
    ``batches`` by the eval-mode forward in ``compute_dtype``; keys are the
    port's module names."""
    names = dense_names(model)
    device = next(model.parameters()).device
    absmax: dict[str, torch.Tensor] = {}

    def record(module, x):
        name = names.get(module)
        if name is not None:
            cur = (x.detach().float().abs().amax() if x.numel()
                   else torch.zeros((), device=x.device))
            prev = absmax.get(name)
            absmax[name] = cur if prev is None else torch.maximum(prev, cur)
        return None

    with torch.inference_mode(), intercept_dense(record):
        for batch in batches:
            cast_forward(model, batch.to(device), compute_dtype, train=False)
    return {name: max(float(a), 1e-8) / 127.0 for name, a in absmax.items()}


def quantize_dense_weights(model: torch.nn.Module, scales: Mapping[str, float]) -> dict:
    """int8-quantize every Dense named by ``scales``. Returns ``{name: (w_q
    int8 [in, out], s_w fp32 [out], bias fp32 | None)}`` on the model's
    device."""
    table: dict[str, tuple] = {}
    for module, name in dense_names(model).items():
        if name not in scales:
            continue
        w_q, s_w = quantize_weight(module.weight.detach().float().t())
        bias = None if module.bias is None else module.bias.detach().float().clone()
        table[name] = (w_q, s_w, bias)
    return table


class QuantizedPredictStep:
    """``batch -> per-head fp32 predictions`` with every calibrated Dense
    computed int8: the fp32 predict step's signature, so the endpoint serves
    it through ``Predictor.outputs(batch, step=...)``. ``scales`` and
    ``weights`` are the tables it was built from."""

    def __init__(self, model: torch.nn.Module, scales: Mapping[str, float],
                 weights: Mapping[str, tuple], compute_dtype: torch.dtype = torch.float32):
        self.model = model
        self.scales = dict(scales)
        self.weights = dict(weights)
        self.compute_dtype = compute_dtype
        self._names = dense_names(model)

    def _dense(self, module, x):
        name = self._names.get(module)
        ent = self.weights.get(name)
        s_x = self.scales.get(name)
        if ent is None or s_x is None:
            return None
        w_q, s_w, bias = ent
        y = quant_dense(x.reshape(-1, x.shape[-1]), w_q, s_w, s_x, bias)
        return y.reshape(x.shape[:-1] + (w_q.shape[1],)).to(x.dtype)

    def __call__(self, batch) -> list[torch.Tensor]:
        with torch.inference_mode(), intercept_dense(self._dense):
            return cast_forward(self.model, batch, self.compute_dtype, train=False)


def make_quantized_predict_step(model: torch.nn.Module, scales: Mapping[str, float],
                                weights: Mapping[str, tuple],
                                compute_dtype: torch.dtype = torch.float32
                                ) -> QuantizedPredictStep:
    """The quantized predict step over ``scales`` and ``weights``."""
    return QuantizedPredictStep(model, scales, weights, compute_dtype)


def certify_quant_error(predictor, quant_step, batches: Sequence) -> list[float]:
    """Per-head max abs deviation |int8 − fp32| over the REAL rows of the
    calibration ``batches``, both answered as served
    (``Predictor.answer``: on the card the two steps' CUDA graphs, the int8
    one captured here at its bucket's first batch): the bounds the endpoint
    certifies."""
    bounds = [0.0] * len(predictor.cols)
    for batch in batches:
        ref = predictor.answer(batch)
        q = predictor.answer(batch, step=quant_step)
        _, ref_rows = predictor.gather(batch, out=ref)
        _, q_rows = predictor.gather(batch, out=q)
        for ihead, (r, p) in enumerate(zip(ref_rows, q_rows)):
            if r.size:
                bounds[ihead] = max(bounds[ihead], float(np.max(np.abs(r - p))))
    return bounds


__all__ = [
    "QuantizationError",
    "QuantizedPredictStep",
    "certify_quant_error",
    "collect_activation_scales",
    "dense_names",
    "make_quantized_predict_step",
    "quantize_dense_weights",
]
