"""The spherical Bessel x Legendre basis of DimeNet's directional messages.

Counterpart of ``hydragnn_tpu/models/spherical.py``::

    sbf[t, l * num_radial + n] = env(d / c) j_l(z_ln d / c) / |j_{l+1}(z_ln)| P_l(cos angle)

over the triplets ``t``, with ``d`` the length of edge ``kj``, ``z_ln`` the
``n``-th positive root of ``j_l`` and ``env`` DimeNet's polynomial envelope.
The roots and normalisers are found once in float64 with scipy
(:func:`spherical_bessel_roots`, :func:`bessel_normalizers`); the module
that uses them holds them as float32 buffers, as the JAX package holds
float32 constants.

``j_l`` blends the upward recurrence (stable for ``x > l``) and Miller's
downward recurrence (stable below), selected per entry; the branch not
selected may overflow fp32 to inf. Differentiating through that selection
would give 0 x inf = NaN, so :class:`_SphericalJn` takes its derivative
from the analytic formula ``j_0' = -j_1``, ``j_l' = j_{l-1} - (l + 1) / x
j_l`` on the finite values alone (the JAX package's custom JVP), and that
derivative is built from the same Function, so a gradient of a gradient
(forces trained through their parameter gradient) stays finite too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# arguments are clamped to at least this (pad triplets have d ~ 0; the
# callers mask them), where the derivative is 0, as jnp.maximum's
_X_MIN = 0.05


def _clamped(x: torch.Tensor) -> torch.Tensor:
    # torch.maximum, not clamp: its gradient at the bound is jnp.maximum's
    return torch.maximum(x, torch.full_like(x, _X_MIN))


def _over(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` as a true division (torch takes a Python number over a
    tensor as a multiply by the reciprocal; jnp divides)."""
    return torch.full_like(t, c) / t


@functools.lru_cache(maxsize=None)
def spherical_bessel_roots(num_spherical: int, num_radial: int) -> np.ndarray:
    """``[num_spherical, num_radial]`` float64: the first ``num_radial``
    positive roots of ``j_l`` for ``l < num_spherical``, bracketed on a 0.1
    grid and refined by Brent's method (read-only)."""
    from scipy import optimize, special

    roots = np.zeros((num_spherical, num_radial))
    for l in range(num_spherical):
        found = []
        x, step = 1e-6, 0.1
        prev = special.spherical_jn(l, x)
        while len(found) < num_radial:
            x2 = x + step
            cur = special.spherical_jn(l, x2)
            if prev == 0.0:
                prev, x = cur, x2
                continue
            if np.sign(prev) != np.sign(cur):
                r = optimize.brentq(lambda t: special.spherical_jn(l, t), x, x2)
                if r > 1e-4:
                    found.append(r)
            prev, x = cur, x2
        roots[l] = found[:num_radial]
    roots.setflags(write=False)
    return roots


@functools.lru_cache(maxsize=None)
def bessel_normalizers(num_spherical: int, num_radial: int) -> np.ndarray:
    """``1 / |j_{l+1}(z_ln)|``, ``[num_spherical, num_radial]`` float64
    (read-only)."""
    from scipy import special

    roots = spherical_bessel_roots(num_spherical, num_radial)
    norm = np.stack([1.0 / np.abs(special.spherical_jn(l + 1, roots[l]))
                     for l in range(num_spherical)])
    norm.setflags(write=False)
    return norm


def _spherical_jn_primal(l_max: int, x: torch.Tensor) -> list:
    """``[j_0, ..., j_lmax]`` of ``max(x, 0.05)``: the upward recurrence
    from the analytic ``j_0``, ``j_1`` where ``x > l``, Miller's downward
    recurrence (started at ``l_max + 8``, normalised against the larger of
    ``j_0`` and ``j_1`` in magnitude) below."""
    safe = _clamped(x)
    j0 = torch.sin(safe) / safe
    j1 = torch.sin(safe) / safe**2 - torch.cos(safe) / safe
    up = [j0, j1]
    for l in range(2, l_max + 1):
        up.append(_over(2 * l - 1, safe) * up[l - 1] - up[l - 2])
    jp1 = torch.zeros_like(safe)
    j = torch.full_like(safe, 1e-18)
    store = {}
    for l in range(l_max + 8, 0, -1):
        jm1 = _over(2 * l + 1, safe) * j - jp1
        jp1, j = j, jm1
        if l - 1 <= max(l_max, 1):
            store[l - 1] = j
    use_j0 = torch.abs(j0) >= torch.abs(j1)
    num = torch.where(use_j0, j0, j1)
    den = torch.where(use_j0, store[0], store[1])
    scale = num / torch.where(den == 0, torch.ones_like(den), den)
    out = [j0]
    for l in range(1, l_max + 1):
        out.append(torch.where(safe > l, up[l], store[l] * scale))
    return out


class _SphericalJn(torch.autograd.Function):
    """``[l_max + 1, *x.shape]``: ``j_0 .. j_lmax`` of ``x``, with the
    analytic derivative (module docstring), 0 where ``x < 0.05``; under
    ``torch.func.vmap`` one call for all members."""

    @staticmethod
    def forward(x, l_max):
        return torch.stack(_spherical_jn_primal(l_max, x))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, l_max = inputs
        ctx.save_for_backward(x)
        ctx.l_max = l_max

    @staticmethod
    def vmap(info, in_dims, x, l_max):
        """Elementwise: the members' ``x`` in one call, the member axis one
        further along behind the stacked orders."""
        return _SphericalJn.apply(x, l_max), in_dims[0] + 1

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        l_max = ctx.l_max
        safe = _clamped(x)
        j = spherical_jn(l_max + 1, x)  # this Function: differentiable again
        derivs = [-j[1]] + [j[l - 1] - _over(l + 1, safe) * j[l] for l in range(1, l_max + 1)]
        live = (x >= _X_MIN).to(x.dtype)
        return (torch.stack(derivs) * live * dout).sum(dim=0), None


def spherical_jn(l_max: int, x: torch.Tensor) -> torch.Tensor:
    """Stacked ``[l_max + 1, *x.shape]`` spherical Bessel values of ``x``."""
    return _SphericalJn.apply(x, l_max)


def legendre(l_max: int, x: torch.Tensor) -> list:
    """``[P_0, ..., P_lmax]`` of ``x`` by Bonnet's recurrence."""
    p = [torch.ones_like(x)]
    if l_max >= 1:
        p.append(x)
    for l in range(2, l_max + 1):
        p.append(((2 * l - 1) * x * p[l - 1] - (l - 1) * p[l - 2]) / l)
    return p


def spherical_basis(dist_kj: torch.Tensor, angle: torch.Tensor, roots: torch.Tensor,
                    norms: torch.Tensor, cutoff: float, envelope_exponent: int = 5
                    ) -> torch.Tensor:
    """``[T]`` lengths of each triplet's edge ``kj`` and ``[T]`` angles ->
    ``[T, num_spherical * num_radial]``; ``roots`` and ``norms`` are the
    ``[num_spherical, num_radial]`` tables on the device. A triplet of zero
    length (a pad triplet) gives exact zeros."""
    from .radial import polynomial_envelope

    num_spherical = roots.shape[0]
    d = dist_kj / cutoff
    env = polynomial_envelope(d, envelope_exponent)
    real = (d > 1e-6).to(env.dtype)
    p = legendre(num_spherical - 1, torch.cos(angle))
    out = []
    for l in range(num_spherical):
        jl = spherical_jn(l, roots[l][None, :] * d[:, None])[l]
        radial = (env * real)[:, None] * jl * norms[l][None, :]
        out.append(radial * p[l][:, None])
    return torch.cat(out, dim=-1)


__all__ = ["bessel_normalizers", "legendre", "spherical_basis", "spherical_bessel_roots",
           "spherical_jn"]
