"""Serving tier: typed admission, bucketed micro-batching, the shared
predict core, int8 quantized serving and the multi-model prediction
server."""

from .admission import (  # noqa: F401
    AdmissionError,
    DeadlineExceededError,
    IncompatibleSampleError,
    OversizeError,
    QueueFullError,
    Request,
    RequestQueue,
    ServerClosedError,
    UnknownModelError,
)
from .batcher import MicroBatcher, canonical_meta, serving_collate  # noqa: F401
from .predictor import Predictor  # noqa: F401
from .quant import QuantizationError  # noqa: F401
from .server import (  # noqa: F401
    ModelEndpoint,
    PredictionServer,
    ServingConfig,
    serving_config_defaults,
)

__all__ = [
    "AdmissionError",
    "DeadlineExceededError",
    "IncompatibleSampleError",
    "MicroBatcher",
    "ModelEndpoint",
    "OversizeError",
    "PredictionServer",
    "Predictor",
    "QuantizationError",
    "QueueFullError",
    "Request",
    "RequestQueue",
    "ServerClosedError",
    "ServingConfig",
    "UnknownModelError",
    "canonical_meta",
    "serving_collate",
    "serving_config_defaults",
]
