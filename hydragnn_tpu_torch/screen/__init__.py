"""Streaming bulk inference ("screening"): plan a whole sample store as
full-bucket blocks, replay the warmed predict graphs over them with the
next blocks staged on a background thread, keep the ranked top-k, resume
exactly after an interruption. Counterpart of ``hydragnn_tpu/screen``; see
``screen.planner`` (layout) and ``screen.engine`` (execution)."""

from .config import ScreeningConfig, screening_config_defaults, screening_config_from
from .engine import BulkScreener, ScreenEntry, ScreenResult
from .planner import ScreenBlock, ScreenPlan, plan_fingerprint, plan_screen

__all__ = [
    "BulkScreener",
    "ScreenBlock",
    "ScreenEntry",
    "ScreenPlan",
    "ScreenResult",
    "ScreeningConfig",
    "plan_fingerprint",
    "plan_screen",
    "screening_config_defaults",
    "screening_config_from",
]
