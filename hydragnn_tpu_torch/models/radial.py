"""Radial basis functions and cutoffs of edge lengths.

Counterpart of ``hydragnn_tpu/models/radial.py``: SchNet's Gaussian
smearing, cosine cutoff and shifted softplus, PNAPlus's Bessel basis with
its polynomial envelope, and the polynomial cutoff, sinc expansion and
Chebyshev basis of the geometric stacks still to port. All are elementwise
functions of the edge lengths in plain PyTorch, as the JAX package leaves
them to XLA.

Types follow the JAX package's promotion: the Gaussian offsets are fp32
(``jnp.linspace``'s default), so a bf16 distance expands to fp32; the
Bessel frequencies are a parameter (flax ``rbf.freq``), cast with the other
parameters by a step's compute dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import edge_operand


def _linspace_fp32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)``'s formula in float32: ``start *
    (1 - t) + stop * t`` with ``t = i / (num - 1)``, the last point ``stop``
    itself (XLA may round an offset 1 ulp the other way)."""
    f32 = np.float32
    if num == 1:
        return np.array([start], f32)
    t = np.arange(num - 1, dtype=f32) / f32(num - 1)
    out = f32(start) * (f32(1) - t) + f32(stop) * t
    return np.concatenate([out, np.array([stop], f32)]).astype(f32)


class GaussianSmearing(nn.Module):
    """Distances ``[E]`` -> ``[E, num_gaussians]`` Gaussians centred on a
    grid over ``[start, stop]``: ``exp(coeff * (d - offset)^2)`` with
    ``coeff = -0.5 / spacing^2`` (SchNet's expansion). The offsets are a
    float32 buffer outside the state dict (flax holds no variable for
    them)."""

    def __init__(self, start: float = 0.0, stop: float = 5.0, num_gaussians: int = 50):
        super().__init__()
        offset = _linspace_fp32(start, stop, num_gaussians)
        # -0.5 / (offset[1] - offset[0]) ** 2, in float32 as jnp computes it
        if num_gaussians > 1:
            gap = np.float32(offset[1] - offset[0])
            self.coeff = float(np.float32(-0.5) / (gap * gap))
        else:
            self.coeff = -0.5
        self.register_buffer("offset", torch.from_numpy(offset), persistent=False)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        d = dist.reshape(-1, 1) - self.offset.reshape(1, -1)
        return torch.exp(self.coeff * (d * d))


def integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` for an integer ``n >= 1`` as ``lax.integer_pow`` computes
    it (``jnp``'s ``x ** n``): by repeated squaring, each product rounded to
    ``x``'s dtype. ``torch.pow`` rounds once, which in bf16 moves a term of
    the envelopes below by an ulp about half the time, and their terms
    cancel (``48 x^6`` has an ulp of 0.25 near ``x = 1``)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def polynomial_envelope(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """DimeNet's smooth envelope on ``x = d / cutoff``: ``1/x + a x^(p-1) +
    b x^p + c x^(p+1)`` with ``p = exponent + 1`` (zero value, slope and
    curvature at ``x = 1``), 0 from ``x = 1`` on."""
    p = exponent + 1
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    env = (1.0 / torch.where(x == 0, torch.ones_like(x), x) + a * integer_pow(x, p - 1)
           + b * integer_pow(x, p) + c * integer_pow(x, p + 1))
    return torch.where(x < 1.0, env, torch.zeros_like(env))


class BesselBasis(nn.Module):
    """DimeNet's Bessel radial basis with the polynomial envelope:
    ``env(d / cutoff) * sin(freq * d / cutoff)``, ``[E] -> [E,
    num_radial]``. ``freq`` is trainable, initialised to ``n * pi``."""

    def __init__(self, num_radial: int = 6, cutoff: float = 5.0, envelope_exponent: int = 5):
        super().__init__()
        self.cutoff = float(cutoff)
        self.envelope_exponent = int(envelope_exponent)
        self.freq = nn.Parameter(
            torch.arange(1, num_radial + 1, dtype=torch.float32) * math.pi)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        d = dist.reshape(-1) / self.cutoff
        env = polynomial_envelope(d, self.envelope_exponent)
        freq = edge_operand(self.freq, d)  # read on edge rows
        return env[:, None] * torch.sin(freq[None, :] * d[:, None])


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """SchNet's cosine window ``0.5 (cos(pi d / cutoff) + 1)`` for ``d <=
    cutoff``, else 0."""
    c = 0.5 * (torch.cos(dist * math.pi / cutoff) + 1.0)
    return torch.where(dist <= cutoff, c, torch.zeros_like(c))


def polynomial_cutoff(dist: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """MACE's ``PolynomialCutoff``: smooth to order ``p``, 1 at 0 and 0 from
    the cutoff on."""
    x = dist / cutoff
    out = (1.0 - ((p + 1.0) * (p + 2.0) / 2.0) * integer_pow(x, p)
           + p * (p + 2.0) * integer_pow(x, p + 1) - (p * (p + 1.0) / 2.0) * integer_pow(x, p + 2))
    return torch.where(x < 1.0, out, torch.zeros_like(out))


def sinc_expansion(dist: torch.Tensor, num_basis: int, cutoff: float) -> torch.Tensor:
    """PaiNN's ``sin(n pi d / cutoff) / d``, ``n = 1..num_basis``, with its
    limit ``n pi / cutoff`` at ``d = 0``."""
    n = torch.arange(1, num_basis + 1, dtype=torch.float32, device=dist.device)
    d = dist.reshape(-1, 1)
    safe = torch.where(d == 0, torch.ones_like(d), d)
    return torch.where(d == 0, n * math.pi / cutoff, torch.sin(n * math.pi * d / cutoff) / safe)


class ChebyshevBasis(nn.Module):
    """Chebyshev polynomials ``T_0 .. T_{num_basis-1}`` of the distance
    rescaled to ``[-1, 1]`` over ``[0, cutoff]`` (clipped)."""

    def __init__(self, num_basis: int = 8, cutoff: float = 5.0):
        super().__init__()
        self.num_basis = int(num_basis)
        self.cutoff = float(cutoff)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        x = 2.0 * dist.reshape(-1) / self.cutoff - 1.0
        # jnp.clip's gradient at the bounds is 1/2 (torch.maximum and
        # minimum split a tie as jnp's do; clamp passes 1)
        x = torch.minimum(torch.maximum(x, torch.full_like(x, -1.0)), torch.ones_like(x))
        out = [torch.ones_like(x), x]
        for _ in range(2, self.num_basis):
            out.append(2.0 * x * out[-1] - out[-2])
        return torch.stack(out[: self.num_basis], dim=-1)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """SchNet's activation, ``softplus(x) - log(2)``."""
    return F.softplus(x) - math.log(2.0)


__all__ = [
    "BesselBasis",
    "ChebyshevBasis",
    "GaussianSmearing",
    "cosine_cutoff",
    "polynomial_cutoff",
    "polynomial_envelope",
    "shifted_softplus",
    "sinc_expansion",
]
