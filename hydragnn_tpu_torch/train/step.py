"""Precision policy and the predict step.

Counterpart of the predict part of ``hydragnn_tpu/train/step.py``. The
predict step casts the parameters and the batch's floating fields to the
compute dtype, leaves the batch-norm running statistics fp32 (the JAX step
passes ``batch_stats`` uncast), and returns fp32 outputs. With bf16 this
means only the first conv layer runs bf16: the first feature norm promotes
to fp32 against its fp32 statistics, and every later layer computes fp32
with bf16-rounded weights, exactly as in the JAX package.

Training steps come with the training slice.
"""

from __future__ import annotations

import torch

PRECISION_MAP = {
    "fp32": torch.float32,
    "float32": torch.float32,
    "fp64": torch.float64,
    "float64": torch.float64,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp16": torch.float16,
    "float16": torch.float16,
}

# "auto": bf16 compute on the card, fp32 elsewhere
KNOWN_PRECISIONS = frozenset(PRECISION_MAP) | {"auto"}


def resolve_precision(name: str, device="cpu") -> torch.dtype:
    if name == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    try:
        return PRECISION_MAP[name]
    except KeyError:
        raise ValueError(
            f"Unknown precision '{name}'; one of {sorted(KNOWN_PRECISIONS)}"
        ) from None


def make_predict_step(model: torch.nn.Module, compute_dtype: torch.dtype = torch.float32):
    """``batch -> per-head fp32 predictions`` for a batch on the model's
    device, under ``torch.inference_mode``."""

    def predict_step(batch):
        with torch.inference_mode():
            params = {
                n: (p.to(compute_dtype) if p.is_floating_point() else p)
                for n, p in model.named_parameters()
            }
            buffers = dict(model.named_buffers())
            c_batch = batch.map_floats(lambda t: t.to(compute_dtype))
            outputs = torch.func.functional_call(model, {**params, **buffers}, (c_batch,))
            return [o.to(torch.float32) for o in outputs]

    return predict_step


__all__ = ["KNOWN_PRECISIONS", "PRECISION_MAP", "make_predict_step", "resolve_precision"]
