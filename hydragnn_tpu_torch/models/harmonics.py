"""Real spherical harmonics and Gaunt (real Clebsch-Gordan) tensor products:
the irreps algebra of MACE.

Counterpart of ``hydragnn_tpu/models/harmonics.py``, the same formulas and
conventions (component normalisation: ``Y_0 = 1`` and ``||Y_l||^2 = 2l + 1``
on the unit sphere; ``m`` ordered ``-l .. l`` with e3nn's axis roles):

* :func:`spherical_harmonics` of edge vectors: explicit Cartesian blocks up
  to ``l = 3``, the recurrence beyond (:func:`_sh_recurrence`), in torch on
  the device;
* the Gaunt coefficients ``G[m1, m2, m3] = (1/4 pi) Int Y_l1 Y_l2 Y_l3``,
  computed once in numpy (float64) by exact Gauss-Legendre x uniform-phi
  quadrature (:func:`gaunt_array`), so the coupling is consistent with the
  harmonics by construction;
* :func:`tensor_product`, the channel-wise equivariant product of two irreps
  dicts ``{l: [..., 2l+1, C]}`` through the Gaunt tables, one
  ``torch.einsum`` per path, the paths summed in the JAX package's order.

The tables reach the device once: a module that calls
:func:`tensor_product` holds them as buffers (:func:`gaunt_buffers`) and
passes them in, so a step captured in a CUDA graph copies nothing from the
host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Real spherical harmonics (component normalisation), m ordered -l..l
# ---------------------------------------------------------------------------


def _sh_blocks(x, y, z, l_max: int, xp):
    """``[Y_0, ..., Y_lmax]`` of unit vectors ``(x, y, z)``, each ``[..., 2l
    + 1]``; ``xp`` is ``numpy`` (the host quadrature) or ``torch``."""
    out = [xp.stack([xp.ones_like(x)], axis=-1)]
    if l_max >= 1:
        c1 = math.sqrt(3.0)
        out.append(xp.stack([c1 * y, c1 * z, c1 * x], axis=-1))
    if l_max >= 2:
        c = math.sqrt(15.0)
        c20 = math.sqrt(5.0)
        out.append(xp.stack([
            c * x * y,
            c * y * z,
            c20 * 0.5 * (3.0 * z * z - 1.0),
            c * x * z,
            c * 0.5 * (x * x - y * y),
        ], axis=-1))
    if l_max >= 3:
        out.append(xp.stack([
            math.sqrt(35.0 / 8.0) * y * (3.0 * x * x - y * y),
            math.sqrt(105.0) * x * y * z,
            math.sqrt(21.0 / 8.0) * y * (5.0 * z * z - 1.0),
            math.sqrt(7.0) * 0.5 * z * (5.0 * z * z - 3.0),
            math.sqrt(21.0 / 8.0) * x * (5.0 * z * z - 1.0),
            math.sqrt(105.0) * 0.5 * z * (x * x - y * y),
            math.sqrt(35.0 / 8.0) * x * (x * x - 3.0 * y * y),
        ], axis=-1))
    if l_max >= 4:
        out.extend(_sh_recurrence(x, y, z, 4, l_max, xp))
    return out


def _sh_recurrence(x, y, z, l_from: int, l_max: int, xp):
    """The blocks ``l_from .. l_max`` by recurrence, in the convention of the
    explicit blocks: ``A_m + i B_m = (x + iy)^m`` carry the ``sin^m`` factor,
    and ``Q[l, m] = P_l^m(z) / sin^m`` follows the standard ``l``-recurrence,
    so every block is a polynomial in ``(x, y, z)``, differentiable and
    finite at the poles."""
    one = xp.ones_like(x)
    a = [one, x]
    b = [xp.zeros_like(x), y]
    for m in range(2, l_max + 1):
        a.append(x * a[m - 1] - y * b[m - 1])
        b.append(x * b[m - 1] + y * a[m - 1])
    q = {}
    for m in range(l_max + 1):
        q[(m, m)] = float(math.prod(range(1, 2 * m, 2))) * one  # (2m-1)!!
        if m + 1 <= l_max:
            q[(m + 1, m)] = (2 * m + 1) * z * q[(m, m)]
        for l in range(m + 2, l_max + 1):
            q[(l, m)] = ((2 * l - 1) * z * q[(l - 1, m)] - (l - 1 + m) * q[(l - 2, m)]) / (l - m)
    blocks = []
    for l in range(l_from, l_max + 1):
        comps = []
        for m in range(-l, l + 1):
            am = abs(m)
            c = math.sqrt((2 * l + 1) * (2.0 if m != 0 else 1.0)
                          * math.factorial(l - am) / math.factorial(l + am))
            base = c * q[(l, am)]
            comps.append(base * b[am] if m < 0 else base * a[am] if m > 0 else base)
        blocks.append(xp.stack(comps, axis=-1))
    return blocks


def spherical_harmonics(vec: torch.Tensor, l_max: int, eps: float = 1e-6) -> list:
    """``[Y_0, ..., Y_lmax]`` (each ``[E, 2l+1]``) of the directions of
    ``vec`` ``[E, 3]``. A zero vector (a pad edge) is replaced by the +z pole
    before the norm, so the gradient stays finite (``sqrt`` at 0 has none,
    and 0 x NaN would defeat the masks downstream)."""
    n2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    # made on the device (no host copy inside a captured step)
    pole = (torch.arange(3, device=vec.device) == 2).to(vec.dtype)
    safe = torch.where(n2 < eps * eps, pole, vec)
    unit = safe / torch.sqrt(torch.sum(safe * safe, dim=-1, keepdim=True))
    return _sh_blocks(unit[..., 0], unit[..., 1], unit[..., 2], l_max, torch)


# ---------------------------------------------------------------------------
# Gaunt coefficients by exact quadrature (host, cached)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _quadrature(l_max_total: int):
    """Gauss-Legendre in ``cos(theta)`` x uniform ``phi``, exact for
    spherical polynomials up to the triple product's degree."""
    n_theta = 2 * l_max_total + 4
    n_phi = 4 * l_max_total + 5
    ct, wt = np.polynomial.legendre.leggauss(n_theta)
    phi = np.arange(n_phi) * (2.0 * np.pi / n_phi)
    st = np.sqrt(1.0 - ct**2)
    x = st[:, None] * np.cos(phi)[None, :]
    y = st[:, None] * np.sin(phi)[None, :]
    z = np.broadcast_to(ct[:, None], x.shape)
    w = np.broadcast_to(wt[:, None], x.shape) * (2.0 * np.pi / n_phi)
    return x.ravel(), y.ravel(), z.ravel(), w.ravel()


@functools.lru_cache(maxsize=None)
def _gaunt(l1: int, l2: int, l3: int) -> np.ndarray:
    x, y, z, w = _quadrature(l1 + l2 + l3)
    blocks = _sh_blocks(x, y, z, max(l1, l2, l3), np)
    g = np.einsum("q,qa,qb,qc->abc", w / (4.0 * np.pi), blocks[l1], blocks[l2], blocks[l3])
    g[np.abs(g) < 1e-12] = 0.0
    g.setflags(write=False)
    return g


def gaunt_array(l1: int, l2: int, l3: int) -> np.ndarray:
    """``G[m1, m2, m3]`` (float64, read-only), zero unless ``|l1 - l2| <= l3
    <= l1 + l2`` and ``l1 + l2 + l3`` is even."""
    return _gaunt(l1, l2, l3)


def coupling_paths(l_in1: int, l_in2: int, l_out_max: int) -> list:
    """Every ``(l1, l2, l3)`` with a nonzero Gaunt coupling within the
    given maxima, in the order :func:`tensor_product` sums them."""
    paths = []
    for l1 in range(l_in1 + 1):
        for l2 in range(l_in2 + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_out_max) + 1):
                if (l1 + l2 + l3) % 2 == 0:
                    paths.append((l1, l2, l3))
    return paths


def gaunt_name(path: tuple) -> str:
    """The buffer name of a path's table (``gaunt_{l1}{l2}{l3}``)."""
    return "gaunt_{}{}{}".format(*path)


def gaunt_buffers(module: torch.nn.Module, paths) -> None:
    """Register each path's table on ``module`` as a float32 buffer outside
    the state dict (the JAX package holds no variable for them), named by
    :func:`gaunt_name`; it moves with the module."""
    for p in paths:
        name = gaunt_name(p)
        if not hasattr(module, name):
            module.register_buffer(name, torch.from_numpy(gaunt_array(*p).astype(np.float32)),
                                   persistent=False)


def tensor_product(u: dict, v: dict, l_out_max: int, tables, weights: dict | None = None
                   ) -> dict:
    """Channel-wise equivariant product of irreps dicts ``{l: [..., 2l+1,
    C]}``::

        out[l3][..., m3, c] = sum_{l1 l2 m1 m2} w[(l1, l2, l3)][..., c]
                              G[m1, m2, m3] u[l1][..., m1, c] v[l2][..., m2, c]

    ``tables(path)`` returns a path's Gaunt table on the device (a module's
    buffer); it is cast to ``u[l1]``'s type, as the JAX package casts it.
    ``weights`` maps a path to broadcastable per-channel weights (``None``:
    1). The paths are summed in the order of ``u``, ``v`` and ``l3``."""
    out: dict = {}
    for l1, ul in u.items():
        for l2, vl in v.items():
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_out_max) + 1):
                if (l1 + l2 + l3) % 2 != 0:
                    continue
                dtype = torch.promote_types(ul.dtype, vl.dtype)
                # the table in u's type first, as the JAX package casts it
                g = tables((l1, l2, l3)).to(ul.dtype).to(dtype)
                term = torch.einsum("abc,...ax,...bx->...cx", g, ul.to(dtype), vl.to(dtype))
                if weights is not None:
                    term = term * weights[(l1, l2, l3)]
                out[l3] = out[l3] + term if l3 in out else term
    return out


def irreps_dim(l_max: int) -> int:
    """``sum_{l <= l_max} (2l + 1)``."""
    return (l_max + 1) ** 2


__all__ = ["coupling_paths", "gaunt_array", "gaunt_buffers", "gaunt_name", "irreps_dim",
           "spherical_harmonics", "tensor_product"]
