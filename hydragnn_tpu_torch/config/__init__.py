"""Config schema: load, augment and type the reference JSON config."""

from .schema import (  # noqa: F401
    HeadBranchSpec,
    ModelSpec,
    get_log_name_config,
    load_config,
    save_config,
    update_config,
    update_multibranch_heads,
)

__all__ = [
    "HeadBranchSpec",
    "ModelSpec",
    "get_log_name_config",
    "load_config",
    "save_config",
    "update_config",
    "update_multibranch_heads",
]
