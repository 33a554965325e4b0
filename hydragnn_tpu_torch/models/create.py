"""Model factory: augmented config dict -> ``HydraModel`` on a device.

Counterpart of ``hydragnn_tpu/models/create.py``. Parameters are drawn from
a seeded ``torch.Generator`` on the host with flax's initialisers, then the
model moves to ``device``.
"""

from __future__ import annotations

import torch

from ..config.schema import ModelSpec
from ..utils import resolve_device
from .base import HydraModel


def create_model(spec: ModelSpec, device="cuda", seed: int = 0) -> HydraModel:
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(int(seed))
    return HydraModel(spec, generator=generator).to(device).eval()


def create_model_config(config: dict, device="cuda", seed: int = 0) -> HydraModel:
    """Build the model from an *augmented* config (after ``update_config``)."""
    return create_model(ModelSpec.from_config(config), device=device, seed=seed)


__all__ = ["create_model", "create_model_config"]
