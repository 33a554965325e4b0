"""hydragnn_tpu_torch: the PyTorch/CUDA port of hydragnn_tpu.

Plain tensor code is PyTorch; every kernel the JAX package wrote in Pallas
for the TPU is a hand-written CUDA kernel here (``csrc/``), built with nvcc
at first use. Entry points run on the card unless the caller passes
``device="cpu"``. On-device molecular dynamics is ``hydragnn_tpu_torch.md``.
"""

from . import md  # noqa: F401
from .config import load_config, update_config  # noqa: F401
from .models import create_model, create_model_config  # noqa: F401
from .run_prediction import run_prediction  # noqa: F401
from .run_training import run_training  # noqa: F401
from .serve import PredictionServer, Predictor, ServingConfig  # noqa: F401

__all__ = [
    "PredictionServer",
    "Predictor",
    "ServingConfig",
    "create_model",
    "create_model_config",
    "load_config",
    "md",
    "run_prediction",
    "run_training",
    "update_config",
]
