"""The validated top-level ``Telemetry`` config block.

Counterpart of ``hydragnn_tpu/telemetry/config.py``: the same fields,
defaults and env overrides.

Single-source pattern (same as ``ServingConfig`` / ``MDConfig`` /
``StoreConfig``): these dataclass field defaults ARE the schema defaults —
``config/schema.py::update_config`` fills and validates the block through
this class, so the JSON schema and the runtime can't drift. Env flags win
over config (``apply_env``): ``HYDRAGNN_TELEMETRY`` overrides ``enabled``,
``HYDRAGNN_TRACE_EVENTS`` overrides ``trace_events``.
"""

from __future__ import annotations

import dataclasses
import os

from ..utils import flags

# top-level sections of the repo's JSON config schema, for telling "a full
# config without a Telemetry block" apart from "a typo'd telemetry block";
# single-sourced from config/schema.py
from ..config.schema import CONFIG_SECTIONS as _CONFIG_SECTIONS


@dataclasses.dataclass
class TelemetryConfig:
    enabled: bool = True        # the whole plane: registry + journal + traces
    journal: bool = True        # write logs/<run>/events.jsonl during runs
    trace_events: bool = False  # record Chrome trace events (trace.json)
    trace_propagate: bool = True  # ship correlation ids across the wire
    ledger: bool = True         # record a cost entry per captured graph

    @staticmethod
    def from_config(config: dict | None) -> "TelemetryConfig":
        """Accepts a FULL config dict (reads its ``Telemetry`` block,
        absent = defaults) or the block itself; unknown keys raise instead
        of silently booting with defaults."""
        config = config or {}
        block = config.get("Telemetry")
        if block is None and config:
            if any(k in telemetry_config_defaults() for k in config):
                block = config
            elif not any(k in _CONFIG_SECTIONS for k in config):
                raise ValueError(
                    f"unrecognized telemetry config keys {sorted(config)}; "
                    f"expected a full config (sections "
                    f"{sorted(_CONFIG_SECTIONS)}) or a Telemetry block "
                    f"(fields {sorted(telemetry_config_defaults())})"
                )
        block = dict(block or {})
        unknown = set(block) - set(telemetry_config_defaults())
        if unknown:
            raise ValueError(
                f"Unknown Telemetry key(s) {sorted(unknown)}; known: "
                f"{sorted(telemetry_config_defaults())}"
            )
        return TelemetryConfig(**block).apply_env()

    def apply_env(self) -> "TelemetryConfig":
        """Fold env overrides in (idempotent); env beats config so an
        operator can silence or arm telemetry per launch without editing
        the run's JSON. An empty-but-set variable counts as unset
        (the ``utils.flags`` convention)."""
        if os.getenv(flags.TELEMETRY.name):
            self.enabled = bool(flags.get(flags.TELEMETRY))
        if os.getenv(flags.TRACE_EVENTS.name):
            self.trace_events = bool(flags.get(flags.TRACE_EVENTS))
        if os.getenv(flags.TRACE_PROPAGATE.name):
            self.trace_propagate = bool(flags.get(flags.TRACE_PROPAGATE))
        if os.getenv(flags.LEDGER.name):
            # HYDRAGNN_LEDGER is a str flag ('0' disables, a path also
            # arms saving); here only the on/off half applies
            self.ledger = str(flags.get(flags.LEDGER)) not in (
                "0", "false", "no", "off")
        return self

    def validate(self) -> "TelemetryConfig":
        for key in ("enabled", "journal", "trace_events", "trace_propagate",
                    "ledger"):
            value = getattr(self, key)
            if not isinstance(value, bool):
                raise ValueError(
                    f"Telemetry.{key} must be a bool, got {value!r}"
                )
        return self


def telemetry_config_defaults() -> dict:
    return dataclasses.asdict(TelemetryConfig())


__all__ = ["TelemetryConfig", "telemetry_config_defaults"]
