"""Output denormalisation."""

from .postprocess import head_scales, output_denormalize  # noqa: F401

__all__ = ["head_scales", "output_denormalize"]
