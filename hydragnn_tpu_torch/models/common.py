"""Shared model components: activations, flax-style dense layers and MLPs,
and the padding-aware batch norm.

Counterpart of ``hydragnn_tpu/models/common.py``. Two behaviours of flax
are kept on purpose, because the port has to compute what the JAX package
computes:

* parameters are initialised as flax initialises them (truncated
  lecun-normal kernels, zero biases), from an explicit ``torch.Generator``;
* a dense layer promotes its input and parameters to their common type
  (``F.linear`` refuses mixed types, flax's ``Dense`` promotes), which is
  what makes the "bf16" predict path run fp32 after the first feature norm.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "selu": F.selu,
    "prelu": lambda x: torch.where(x >= 0, x, 0.25 * x),  # torch PReLU init slope
    "elu": F.elu,
    "lrelu_01": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "lrelu_025": lambda x: F.leaky_relu(x, negative_slope=0.25),
    "lrelu_05": lambda x: F.leaky_relu(x, negative_slope=0.5),
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
    "tanh": torch.tanh,
    "silu": F.silu,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'; supported: {sorted(_ACTIVATIONS)}"
        ) from None


# stddev of a unit normal truncated to [-2, 2]; flax divides by it so the
# truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``variance_scaling(1.0, "fan_in", "truncated_normal")`` on a
    ``[out, in]`` weight (fan_in = in)."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``y = x @ W.T + b`` after promoting ``x``, ``W``
    and ``b`` to their common dtype. ``weight`` is ``[out, in]``."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(torch.promote_types(x.dtype, self.weight.dtype),
                                    self.bias.dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))


class MLP(nn.Module):
    """Dense stack with the activation between layers (the last layer is
    linear unless ``act_last``). Layers are named ``dense_{i}`` as in flax."""

    def __init__(self, in_features: int, features: Sequence[int], activation: str = "relu",
                 act_last: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.activation = activation
        self.act_last = act_last
        d = in_features
        for i, f in enumerate(self.features):
            self.add_module(f"dense_{i}", Dense(d, f, generator))
            d = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = get_activation(self.activation)
        n = len(self.features)
        for i in range(n):
            x = getattr(self, f"dense_{i}")(x)
            if i < n - 1 or self.act_last:
                x = act(x)
        return x


class MaskedBatchNorm(nn.Module):
    """Batch norm over valid rows only, eval mode: normalise with the
    running statistics. ``scale``/``bias`` are parameters; the running
    ``mean``/``var`` are fp32 buffers that stay fp32 when the parameters are
    cast to a compute dtype, as the JAX predict step leaves ``batch_stats``
    uncast. Train mode (masked statistics, EMA update) comes with the
    training slice."""

    def __init__(self, features: int, epsilon: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features, dtype=torch.float32))
        self.register_buffer("var", torch.ones(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(
                "MaskedBatchNorm train mode comes with the training slice of the port"
            )
        y = (x - self.mean) * torch.rsqrt(self.var + self.epsilon)
        return y * self.scale + self.bias


__all__ = ["Dense", "MLP", "MaskedBatchNorm", "get_activation", "lecun_normal_"]
