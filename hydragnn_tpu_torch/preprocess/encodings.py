"""Laplacian positional encodings for GPS global attention (host side, numpy).

Counterpart of ``hydragnn_tpu/preprocess/encodings.py``: per sample, the
``k`` eigenvectors of the symmetric-normalised graph Laplacian after the
trivial one, sign-fixed so the largest-magnitude entry of each is positive,
zero-padded when the graph has fewer than ``k + 1`` nodes; and the relative
edge encodings ``rel_pe = |pe[src] - pe[dst]|``.
"""

from __future__ import annotations

import numpy as np

from ..graphs.graph import GraphSample


def laplacian_pe(senders, receivers, num_nodes: int, k: int) -> np.ndarray:
    """The ``k`` smallest non-trivial eigenvectors of the normalised
    Laplacian, ``[num_nodes, k]`` float32."""
    adj = np.zeros((num_nodes, num_nodes))
    adj[senders, receivers] = 1.0
    adj = np.maximum(adj, adj.T)
    deg = adj.sum(axis=1)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = np.eye(num_nodes) - (dinv[:, None] * adj * dinv[None, :])
    vals, vecs = np.linalg.eigh(lap)
    order = np.argsort(vals)
    pe = vecs[:, order[1 : k + 1]]
    if pe.shape[1] < k:
        pe = np.pad(pe, ((0, 0), (0, k - pe.shape[1])))
    for j in range(pe.shape[1]):
        i = np.argmax(np.abs(pe[:, j]))
        if pe[i, j] < 0:
            pe[:, j] = -pe[:, j]
    return pe.astype(np.float32)


def attach_lap_pe(sample: GraphSample, k: int) -> GraphSample:
    """Compute and cache ``pe``/``rel_pe`` in ``sample.extras`` (idempotent
    for the same ``k``)."""
    if "pe" in sample.extras and sample.extras["pe"].shape[1] == k:
        return sample
    pe = laplacian_pe(sample.senders, sample.receivers, sample.num_nodes, k)
    sample.extras["pe"] = pe
    sample.extras["rel_pe"] = np.abs(pe[sample.senders] - pe[sample.receivers])
    return sample


__all__ = ["attach_lap_pe", "laplacian_pe"]
