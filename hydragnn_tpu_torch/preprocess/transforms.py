"""Geometric preprocessing transforms (host side, numpy).

Counterpart of ``hydragnn_tpu/preprocess/transforms.py``, with the same
numpy operations in the same order, so that every result is bit-equal to
the JAX package's:

* :func:`normalize_rotation`: each structure rotated into its principal-axis
  (PCA) frame, right-handed (``Dataset.rotational_invariance``);
* :func:`attach_edge_lengths` and :func:`normalize_edge_lengths_global`: the
  Euclidean edge length appended to ``edge_attr``, then every sample's
  ``edge_attr`` divided by the dataset's largest entry
  (``Dataset.compute_edge_lengths``);
* :func:`spherical_features`: per-edge ``(rho, theta, phi)`` of the
  relative position, normalised (``Descriptors.spherical_coordinates``);
* :func:`point_pair_features`: per-edge ``(|d|, angle(n_s, d), angle(n_r,
  d), angle(n_s, n_r))`` from node normals (``Descriptors.point_pair_features``);
* :func:`stratified_subsample`: a draw of ``subsample_percentage`` of the
  dataset that keeps the share of each composition category
  (``Variables_of_interest.subsample_percentage``).

Every transform but the global normalisation and the subsample mutates its
``GraphSample`` in place and returns it.
"""

from __future__ import annotations

import numpy as np

from ..graphs.graph import GraphSample


def normalize_rotation(sample: GraphSample) -> GraphSample:
    """Rotate positions into the principal-axis frame: centred positions
    times the right singular vectors, made a proper rotation. Force targets
    and periodic edge shifts rotate with the frame."""
    pos = np.asarray(sample.pos, np.float64)
    if pos.shape[0] < 2:
        return sample
    centered = pos - pos.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    rot = vt.T
    if np.linalg.det(rot) < 0:  # keep chirality: proper rotation only
        rot[:, -1] *= -1.0
    sample.pos = (centered @ rot).astype(np.float32)
    if sample.forces_y is not None and np.any(sample.forces_y):
        sample.forces_y = (np.asarray(sample.forces_y, np.float64) @ rot).astype(np.float32)
    if sample.num_edges and np.any(sample.edge_shifts):
        sample.edge_shifts = (np.asarray(sample.edge_shifts, np.float64) @ rot).astype(
            np.float32)
    return sample


def _edge_vectors(sample: GraphSample) -> np.ndarray:
    pos = np.asarray(sample.pos)
    return pos[sample.receivers] - pos[sample.senders] + np.asarray(sample.edge_shifts)


def _append_columns(sample: GraphSample, cols: np.ndarray) -> GraphSample:
    ea = np.asarray(sample.edge_attr, np.float32)
    if ea.size == 0:
        ea = ea.reshape(sample.num_edges, 0)
    sample.edge_attr = np.concatenate([ea, cols], axis=1)
    return sample


def attach_edge_lengths(sample: GraphSample) -> GraphSample:
    """Append the Euclidean edge length as an ``edge_attr`` column."""
    d = np.linalg.norm(_edge_vectors(sample), axis=1, keepdims=True).astype(np.float32)
    return _append_columns(sample, d)


def _process_max(local_max: float) -> float:
    """The largest of every process's ``local_max``: an all-reduce MAX when
    ``torch.distributed`` runs more than one process, else ``local_max``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return local_max
    import torch

    t = torch.tensor([local_max], dtype=torch.float32)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.cpu()[0])


def normalize_edge_lengths_global(samples, eps: float = 1e-12) -> float:
    """Divide every sample's ``edge_attr`` by the largest entry over the
    dataset and, under ``torch.distributed`` with more than one process,
    over every process. Returns the divisor (1.0 where the largest entry is
    not finite or within ``eps`` of 0, and then nothing is divided)."""
    local_max = float("-inf")
    for s in samples:
        if s.edge_attr.size:
            local_max = max(local_max, float(np.max(s.edge_attr)))
    global_max = _process_max(local_max)
    if not np.isfinite(global_max) or abs(global_max) < eps:
        return 1.0
    for s in samples:
        if s.edge_attr.size:
            s.edge_attr = (s.edge_attr / global_max).astype(np.float32)
    return global_max


def spherical_features(sample: GraphSample, norm: bool = True) -> GraphSample:
    """Append per-edge spherical coordinates ``(rho, theta, phi)`` of the
    relative position; ``norm`` scales rho by its largest value, theta by
    2 pi and phi by pi."""
    vec = _edge_vectors(sample)
    rho = np.linalg.norm(vec, axis=1)
    theta = np.arctan2(vec[:, 1], vec[:, 0])
    theta = np.where(theta < 0, theta + 2 * np.pi, theta)
    safe_rho = np.where(rho > 0, rho, 1.0)
    phi = np.arccos(np.clip(vec[:, 2] / safe_rho, -1.0, 1.0))
    if norm:
        rho = rho / max(float(rho.max()) if rho.size else 1.0, 1e-12)
        theta = theta / (2 * np.pi)
        phi = phi / np.pi
    return _append_columns(sample, np.stack([rho, theta, phi], axis=1).astype(np.float32))


def point_pair_features(sample: GraphSample) -> GraphSample:
    """Append, for edge ``(s, r)`` with relative vector ``d`` and node
    normals ``n_s``, ``n_r``: ``(|d|, angle(n_s, d), angle(n_r, d),
    angle(n_s, n_r))``. Normals come from ``extras['normal']``, else +z."""
    vec = _edge_vectors(sample)
    n = sample.num_nodes
    normal = np.asarray(sample.extras.get("normal", np.tile([0.0, 0.0, 1.0], (n, 1))),
                        np.float64)
    ns = normal[sample.senders]
    nr = normal[sample.receivers]

    def angle(a, b):
        cross = np.linalg.norm(np.cross(a, b), axis=1)
        dot = np.sum(a * b, axis=1)
        return np.arctan2(cross, dot)

    d = np.linalg.norm(vec, axis=1)
    feats = np.stack([d, angle(ns, vec), angle(nr, vec), angle(ns, nr)], axis=1)
    return _append_columns(sample, feats.astype(np.float32))


def composition_category(sample: GraphSample, type_column: int = 0) -> int:
    """The stratification key: the sorted positive per-type counts ``f_i``
    combined as ``sum(f_i * 100 ** i)``."""
    types = np.asarray(sample.x[:, type_column]).astype(np.int64)
    freq = np.bincount(types[types >= 0])
    freq = sorted(int(f) for f in freq if f > 0)
    return int(sum(f * (100**i) for i, f in enumerate(freq)))


def stratified_subsample(samples, percentage: float, seed: int = 0, type_column: int = 0):
    """A seeded draw of ``percentage`` of ``samples`` (at least one of each
    composition category), in the samples' order."""
    if not 0.0 < percentage <= 1.0:
        raise ValueError(f"subsample_percentage must be in (0, 1], got {percentage}")
    cats = np.array([composition_category(s, type_column) for s in samples])
    rng = np.random.default_rng(seed)
    picked: list[int] = []
    for cat in np.unique(cats):
        idx = np.flatnonzero(cats == cat)
        k = max(1, int(round(len(idx) * percentage)))
        picked.extend(rng.choice(idx, size=min(k, len(idx)), replace=False).tolist())
    picked.sort()
    return [samples[i] for i in picked]


__all__ = [
    "attach_edge_lengths",
    "composition_category",
    "normalize_edge_lengths_global",
    "normalize_rotation",
    "point_pair_features",
    "spherical_features",
    "stratified_subsample",
]
