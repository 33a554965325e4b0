"""Config schema: load, augment and type the reference JSON config."""

from .schema import (  # noqa: F401
    HeadBranchSpec,
    ModelSpec,
    load_config,
    update_config,
    update_multibranch_heads,
)

__all__ = [
    "HeadBranchSpec",
    "ModelSpec",
    "load_config",
    "update_config",
    "update_multibranch_heads",
]
