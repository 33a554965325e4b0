"""Serving tier: typed admission, bucketed micro-batching, the shared
predict core, int8 quantized serving, the multi-model prediction server,
synthetic traffic and the multi-process fleet (``serve.fleet``)."""

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
from .fleet import (  # noqa: F401
    AnswerCache,
    Autoscaler,
    AutoscalerConfig,
    CanaryMismatchError,
    FleetConfig,
    FleetRouter,
    ReplicaBootError,
    ReplicaHost,
    RolloutConfig,
    answer_key,
    blue_green_rollout,
    fleet_config_defaults,
    spawn_replica,
)
from .predictor import Predictor  # noqa: F401
from .quant import QuantizationError  # noqa: F401
from .server import (  # noqa: F401
    ModelEndpoint,
    PredictionServer,
    ServingConfig,
    serving_config_defaults,
)
from .traffic import (  # noqa: F401
    TrafficReport,
    mixed_priority_plan,
    run_traffic,
    zipf_duplicate_order,
)

__all__ = [
    "AdmissionError",
    "AnswerCache",
    "Autoscaler",
    "AutoscalerConfig",
    "CanaryMismatchError",
    "DeadlineExceededError",
    "FleetConfig",
    "FleetRouter",
    "IncompatibleSampleError",
    "MicroBatcher",
    "ModelEndpoint",
    "OversizeError",
    "PredictionServer",
    "Predictor",
    "QuantizationError",
    "QueueFullError",
    "ReplicaBootError",
    "ReplicaHost",
    "Request",
    "RequestQueue",
    "RolloutConfig",
    "ServerClosedError",
    "ServingConfig",
    "TrafficReport",
    "UnknownModelError",
    "answer_key",
    "blue_green_rollout",
    "canonical_meta",
    "fleet_config_defaults",
    "mixed_priority_plan",
    "run_traffic",
    "serving_collate",
    "serving_config_defaults",
    "spawn_replica",
    "zipf_duplicate_order",
]
