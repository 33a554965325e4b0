"""Graph samples, padded batches, radius graphs and segment reductions."""

from .batching import (  # noqa: F401
    GraphLoader,
    PadSpec,
    collate,
    compute_pad_buckets,
    compute_pad_spec,
    pick_bucket,
)
from .graph import BatchMeta, GraphBatch, GraphSample  # noqa: F401
from .radius import build_radius_graph, radius_graph  # noqa: F401

__all__ = [
    "BatchMeta",
    "GraphBatch",
    "GraphLoader",
    "GraphSample",
    "PadSpec",
    "build_radius_graph",
    "collate",
    "compute_pad_buckets",
    "compute_pad_spec",
    "pick_bucket",
    "radius_graph",
]
