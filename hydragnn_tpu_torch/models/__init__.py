"""Models: the HydraModel skeleton, the GIN conv layer and the factory."""

from .base import HydraModel, head_columns  # noqa: F401
from .create import create_model, create_model_config  # noqa: F401

__all__ = ["HydraModel", "create_model", "create_model_config", "head_columns"]
