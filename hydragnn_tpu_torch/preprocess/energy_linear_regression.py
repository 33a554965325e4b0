"""Energy linear-regression baseline removal.

Parity target: ``hydragnn/preprocess/energy_linear_regression.py`` — fit
per-element reference energies by least squares over composition histograms
(118-bin periodic table), subtract the linear baseline from every sample's
energy target, and record the coefficients with the dataset. The reference
runs this MPI-distributed over ADIOS files; here each process accumulates
the normal equations of its samples, the processes of a
``torch.distributed`` group sum them (as the JAX package sums them, from
float32 copies), and the solve is the same SVD pseudo-inverse.

Counterpart of ``hydragnn_tpu/preprocess/energy_linear_regression.py``.
"""

from __future__ import annotations

import numpy as np

N_ELEMENTS = 118


def composition_histogram(atom_types: np.ndarray) -> np.ndarray:
    """118-bin histogram of atomic numbers (reference ``:118-121``)."""
    types = np.round(np.asarray(atom_types).reshape(-1)).astype(int)
    hist, _ = np.histogram(types, bins=range(1, N_ELEMENTS + 2))
    return hist.astype(np.float64)


def solve_least_squares_svd(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """SVD pseudo-inverse solve (reference ``solve_least_squares_svd``), with
    small singular values cut (rank-deficient A is the normal case: most
    elements never appear)."""
    U, S, Vt = np.linalg.svd(A, full_matrices=False)
    cutoff = S.max() * max(A.shape) * np.finfo(S.dtype).eps if S.size else 0.0
    S_inv = np.where(S > cutoff, 1.0 / np.where(S > cutoff, S, 1.0), 0.0)
    return Vt.T @ (S_inv * (U.T @ b))


def _sample_energy(s) -> float:
    if s.energy_y is not None and np.any(s.energy_y):
        return float(np.asarray(s.energy_y).reshape(-1)[0])
    return float(np.asarray(s.graph_y).reshape(-1)[0])


def fit_energy_linear_regression(samples, z_column: int = 0) -> np.ndarray:
    """Fit the per-element baseline x from  sum_i ||hist_i . x - E_i||^2 via
    normal equations (A = X^T X, b = X^T e; the reference's ``:131-144``),
    summed over the processes of the ``torch.distributed`` group."""
    A = np.zeros((N_ELEMENTS, N_ELEMENTS))
    b = np.zeros(N_ELEMENTS)
    for s in samples:
        h = composition_histogram(np.asarray(s.x)[:, z_column])
        A += np.outer(h, h)
        b += h * _sample_energy(s)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        mine = np.concatenate([A.reshape(-1), b]).astype(np.float32)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        summed = np.stack(every).sum(axis=0).astype(np.float64)
        A = summed[: N_ELEMENTS * N_ELEMENTS].reshape(N_ELEMENTS, N_ELEMENTS)
        b = summed[N_ELEMENTS * N_ELEMENTS:]
    return solve_least_squares_svd(A, b)


def apply_energy_linear_regression(samples, coeff: np.ndarray, z_column: int = 0):
    """Subtract the linear baseline from every sample's energy target
    (graph_y[0] and energy_y, the reference's ``data.energy``/``data.y[0]``
    update ``:152-174``). Mutates in place; returns the samples."""
    coeff = np.asarray(coeff, np.float64)
    for s in samples:
        h = composition_histogram(np.asarray(s.x)[:, z_column])
        baseline = float(h @ coeff)
        if s.energy_y is not None and np.any(s.energy_y):
            s.energy_y = (np.asarray(s.energy_y, np.float32) - baseline).astype(
                np.float32
            )
        gy = np.asarray(s.graph_y, np.float32).copy()
        if gy.size:
            gy[0] -= baseline
            s.graph_y = gy
    return samples


def energy_linear_regression_packed(input_path: str, output_path: str) -> np.ndarray:
    """File-level driver (the reference CLI over ADIOS files): read a packed
    dataset, fit+apply the baseline, write a new packed file with the
    coefficients recorded in attrs. Returns the coefficients."""
    from ..datasets.packed import PackedDataset, PackedWriter

    ds = PackedDataset(input_path)
    samples = ds.load_all()
    coeff = fit_energy_linear_regression(samples)
    apply_energy_linear_regression(samples, coeff)
    attrs = dict(ds.attrs)
    attrs["energy_linear_regression_coeff"] = np.asarray(coeff).tolist()
    PackedWriter(samples, output_path, attrs=attrs)
    return coeff
