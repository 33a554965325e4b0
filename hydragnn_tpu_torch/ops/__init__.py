"""Hand-written CUDA kernels of the port and the plain PyTorch versions
beside them (``fused_scatter``), plus their nvcc build (``_build``)."""

from .fused_scatter import (  # noqa: F401
    LAUNCHES,
    SegmentIndex,
    fused_segment_sum,
    gather_scatter_sum,
    plain_gather_scatter_sum,
    plain_segment_sum,
    reset_launches,
    segment_index,
)

__all__ = [
    "LAUNCHES",
    "SegmentIndex",
    "fused_segment_sum",
    "gather_scatter_sum",
    "plain_gather_scatter_sum",
    "plain_segment_sum",
    "reset_launches",
    "segment_index",
]
