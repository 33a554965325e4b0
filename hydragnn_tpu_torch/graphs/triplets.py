"""Triplet (angle) indices for DimeNet's directional message passing.

Counterpart of ``hydragnn_tpu/graphs/triplets.py``: for every directed edge
``ji = (j -> i)``, every edge ``kj = (k -> j)`` with ``k != i``; DimeNet's
interaction block mixes the edge embeddings along these ``kj -> ji`` pairs,
weighted by the spherical basis of the angle at ``j``. The indices are host
preprocessing in numpy, computed once per sample, and collate offsets and
pads them (pad triplets point at the last edge slot); the angle itself is
computed on the device from the edge vectors, since it moves with the
positions.

``idx_ji`` comes out non-decreasing (the loop runs over ``ji``), so a
collated batch's ``idx_ji`` is sorted and collate certifies it
(``BatchMeta.ji_sorted``): the CSR view the triplet sum runs over needs no
argsort.
"""

from __future__ import annotations

import numpy as np

from .graph import GraphSample


def build_triplets(senders: np.ndarray, receivers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(idx_kj, idx_ji)`` int32 edge ids: for each edge ``ji = (j -> i)``
    and each edge ``kj = (k -> j)`` with ``k != i``, in order of ``ji``, and
    for one ``ji`` in the stable order of the edges into ``j``."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    e = senders.shape[0]
    if e == 0:
        z = np.zeros((0,), np.int32)
        return z, z
    # the edges into each node: receiver-sorted, with each node's bounds
    order = np.argsort(receivers, kind="stable")
    starts = np.searchsorted(receivers[order], np.arange(receivers.max() + 2))
    idx_kj, idx_ji = [], []
    for ji in range(e):
        j, i = senders[ji], receivers[ji]
        if j >= len(starts) - 1:
            continue
        into_j = order[starts[j] : starts[j + 1]]
        kj = into_j[senders[into_j] != i]
        if kj.size:
            idx_kj.append(kj)
            idx_ji.append(np.full(kj.shape, ji, np.int64))
    if not idx_kj:
        z = np.zeros((0,), np.int32)
        return z, z
    return (np.concatenate(idx_kj).astype(np.int32),
            np.concatenate(idx_ji).astype(np.int32))


def attach_triplets(sample: GraphSample) -> GraphSample:
    """Compute the triplet indices of ``sample`` into its ``extras``
    (``idx_kj``, ``idx_ji``); returns the sample."""
    idx_kj, idx_ji = build_triplets(sample.senders, sample.receivers)
    sample.extras["idx_kj"] = idx_kj
    sample.extras["idx_ji"] = idx_ji
    return sample


__all__ = ["attach_triplets", "build_triplets"]
