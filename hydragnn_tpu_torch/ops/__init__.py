"""Hand-written CUDA kernels of the port and the plain PyTorch versions
beside them (``fused_scatter``: segment reductions; ``fused_softmax``:
attention softmaxes; ``fused_cell_list``: the MD cell-list neighbour
build; ``quant_matmul``: the int8 dense layer of quantized serving;
``fp8_matmul``: the experimental fp8 dense layer), plus their nvcc build
(``_build``)."""

from .fp8_matmul import certify_fp8_dense, fp8_dense  # noqa: F401
from .fused_cell_list import binned_radius_graph, plain_cell_pairs  # noqa: F401
from .fused_scatter import (  # noqa: F401
    LAUNCHES,
    SegmentIndex,
    fused_segment_sum,
    gather_rows,
    gather_scatter_sum,
    gather_scatter_sum_bwd,
    plain_gather_scatter_sum,
    plain_segment_sum,
    reset_launches,
    segment_index,
)
from .fused_softmax import (  # noqa: F401
    masked_softmax,
    plain_masked_softmax,
    plain_segment_softmax,
    segment_softmax,
    self_loop_pad,
)
from .quant_matmul import quant_dense, quantize_weight  # noqa: F401

__all__ = [
    "LAUNCHES",
    "SegmentIndex",
    "binned_radius_graph",
    "certify_fp8_dense",
    "fp8_dense",
    "fused_segment_sum",
    "gather_rows",
    "gather_scatter_sum",
    "gather_scatter_sum_bwd",
    "masked_softmax",
    "plain_cell_pairs",
    "plain_gather_scatter_sum",
    "plain_masked_softmax",
    "plain_segment_softmax",
    "plain_segment_sum",
    "quant_dense",
    "quantize_weight",
    "reset_launches",
    "segment_index",
    "segment_softmax",
    "self_loop_pad",
]
