"""The ``Serving.fleet`` config block, single-sourced from one dataclass.

Counterpart of ``hydragnn_tpu/serve/fleet/config.py``: the
:class:`FleetConfig` field defaults are the schema defaults
(``config.update_config`` fills the nested block from
``fleet_config_defaults`` and validates it through ``validate()``), and the
control planes nest in it: ``Serving.fleet.autoscale``
(:class:`AutoscalerConfig`) and ``Serving.fleet.rollout``
(:class:`RolloutConfig`), each with the same unknown-key-rejecting
validation. The JAX package's ``HYDRAGNN_FLEET_*`` environment overrides
are not ported (its flag table is a later slice): a config here is what its
dict says. ``serialized_boot`` is accepted so that a config augmented by the
JAX package validates, and read by nothing: every replica boot captures its
CUDA graphs anew.

Import-light (stdlib only): the config schema validates this block at
config-load time.
"""

from __future__ import annotations

import dataclasses

PRIORITY_CLASSES = ("interactive", "batch", "best_effort")


def _dataclass_defaults(cls) -> dict:
    """``{field: default}`` for a config dataclass, honoring
    ``default_factory`` fields (plain ``f.default`` is MISSING for those,
    which would silently drop a nested block out of the schema)."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = f.default_factory()
    return out


def _nested_block(config, key: str, known: dict, what: str) -> dict:
    """Resolve the ``Serving.fleet.<key>`` block from a full config, the
    ``Serving`` block, the ``fleet`` block, or the block itself
    (recognized by its field names — a typo'd block raises instead of
    silently falling back to defaults)."""
    config = config or {}
    if not isinstance(config, dict):
        raise ValueError(f"{what} must be a dict, got {type(config).__name__}")
    for outer in ("Serving", "fleet"):
        if outer in config:
            config = config[outer] or {}
            if not isinstance(config, dict):
                raise ValueError(
                    f"{outer} must be a dict, got {type(config).__name__}"
                )
    if key in config:
        block = config[key]
    elif config and not any(k in known for k in config):
        raise ValueError(
            f"unrecognized {what} config keys {sorted(config)}; "
            f"expected Serving.fleet.{key} fields {sorted(known)}"
        )
    else:
        block = config
    if block is None:
        return {}
    if not isinstance(block, dict):
        raise ValueError(
            f"Serving.fleet.{key} must be a dict, got {type(block).__name__}"
        )
    return block


@dataclasses.dataclass
class AutoscalerConfig:
    """The ``Serving.fleet.autoscale`` block: SLO targets + control-loop
    discipline for :class:`~hydragnn_tpu_torch.serve.fleet.autoscaler.Autoscaler`.

    * ``enabled`` — arm the control loop. Off, the fleet survives faults
      but never repairs them.
    * ``interval_s`` — metrics poll period of the control loop.
    * ``min_replicas`` / ``max_replicas`` — the replica budget the loop
      may move within; it never retires below min nor spawns past max.
    * ``target_p99_ms`` — interactive-class p99 SLO; a recent p99 above
      it is a scale-up breach.
    * ``max_queue_per_replica`` — admission backlog per ACTIVE replica
      tolerated before queue depth counts as a breach.
    * ``shed_tolerance`` — sheds per poll interval tolerated before the
      shed rate counts as a breach.
    * ``up_consecutive`` / ``down_consecutive`` — hysteresis: that many
      CONSECUTIVE breach (calm) polls before a spawn (retire). Calm needs
      a longer streak than breach — capacity mistakes are asymmetric.
    * ``cooldown_s`` — dead time after any action (a fresh replica needs
      a poll or two of traffic before its effect is measurable; acting
      again inside the window double-corrects).
    * ``down_fraction`` — scale-down requires p99 under
      ``down_fraction * target_p99_ms`` (not merely under target), so the
      loop never oscillates around the SLO boundary.
    * ``drain_timeout_s`` — bound on draining a retiring replica's
      in-flight work before its rank is detached.
    """

    enabled: bool = False
    interval_s: float = 1.0
    min_replicas: int = 1
    max_replicas: int = 4
    target_p99_ms: float = 500.0
    max_queue_per_replica: int = 8
    shed_tolerance: int = 0
    up_consecutive: int = 2
    down_consecutive: int = 5
    cooldown_s: float = 10.0
    down_fraction: float = 0.3
    drain_timeout_s: float = 30.0

    @staticmethod
    def from_config(config: "dict | AutoscalerConfig | None") -> "AutoscalerConfig":
        if isinstance(config, AutoscalerConfig):
            return dataclasses.replace(config)
        block = _nested_block(
            config, "autoscale", autoscaler_config_defaults(), "autoscale"
        )
        unknown = set(block) - set(autoscaler_config_defaults())
        if unknown:
            raise ValueError(
                f"Unknown Serving.fleet.autoscale key(s) {sorted(unknown)}; "
                f"known: {sorted(autoscaler_config_defaults())}"
            )
        return AutoscalerConfig(**block)


    def validate(self) -> "AutoscalerConfig":
        if int(self.min_replicas) < 1:
            raise ValueError(
                "Serving.fleet.autoscale.min_replicas must be >= 1, got "
                f"{self.min_replicas}"
            )
        if int(self.max_replicas) < int(self.min_replicas):
            raise ValueError(
                "Serving.fleet.autoscale.max_replicas must be >= "
                f"min_replicas ({self.min_replicas}), got {self.max_replicas}"
            )
        for key in ("interval_s", "target_p99_ms", "drain_timeout_s",
                    "down_fraction"):
            if float(getattr(self, key)) <= 0:
                raise ValueError(
                    f"Serving.fleet.autoscale.{key} must be > 0, got "
                    f"{getattr(self, key)}"
                )
        if float(self.down_fraction) >= 1.0:
            raise ValueError(
                "Serving.fleet.autoscale.down_fraction must be < 1 (scale "
                "down only well clear of the SLO boundary), got "
                f"{self.down_fraction}"
            )
        for key in ("up_consecutive", "down_consecutive",
                    "max_queue_per_replica"):
            if int(getattr(self, key)) < 1:
                raise ValueError(
                    f"Serving.fleet.autoscale.{key} must be >= 1, got "
                    f"{getattr(self, key)}"
                )
        if int(self.shed_tolerance) < 0:
            raise ValueError(
                "Serving.fleet.autoscale.shed_tolerance must be >= 0, got "
                f"{self.shed_tolerance}"
            )
        if float(self.cooldown_s) < 0:
            raise ValueError(
                "Serving.fleet.autoscale.cooldown_s must be >= 0, got "
                f"{self.cooldown_s}"
            )
        return self


@dataclasses.dataclass
class RolloutConfig:
    """The ``Serving.fleet.rollout`` block: blue/green cutover knobs for
    :func:`~hydragnn_tpu_torch.serve.fleet.rollout.blue_green_rollout`.

    * ``canary`` — require the bit-identity canary before cutover
      Disabling it trades the
      served-answer parity proof for rollout speed — never do that for a
      checkpoint whose architecture changed.
    * ``canary_probes`` — pinned probe requests compared bit-for-bit
      between the live set and every green replica.
    * ``probe_timeout_s`` — per canary round-trip deadline.
    * ``drain_timeout_s`` — bound on draining each blue replica's
      in-flight work after cutover before its rank is detached.
    """

    canary: bool = True
    canary_probes: int = 4
    probe_timeout_s: float = 30.0
    drain_timeout_s: float = 30.0

    @staticmethod
    def from_config(config: "dict | RolloutConfig | None") -> "RolloutConfig":
        if isinstance(config, RolloutConfig):
            return dataclasses.replace(config)
        block = _nested_block(
            config, "rollout", rollout_config_defaults(), "rollout"
        )
        unknown = set(block) - set(rollout_config_defaults())
        if unknown:
            raise ValueError(
                f"Unknown Serving.fleet.rollout key(s) {sorted(unknown)}; "
                f"known: {sorted(rollout_config_defaults())}"
            )
        return RolloutConfig(**block)


    def validate(self) -> "RolloutConfig":
        if int(self.canary_probes) < 1:
            raise ValueError(
                "Serving.fleet.rollout.canary_probes must be >= 1, got "
                f"{self.canary_probes}"
            )
        for key in ("probe_timeout_s", "drain_timeout_s"):
            if float(getattr(self, key)) <= 0:
                raise ValueError(
                    f"Serving.fleet.rollout.{key} must be > 0, got "
                    f"{getattr(self, key)}"
                )
        return self


def autoscaler_config_defaults() -> dict:
    """``{key: default}`` for ``Serving.fleet.autoscale`` (derived from the
    dataclass fields — same single-sourcing as the parent block)."""
    return _dataclass_defaults(AutoscalerConfig)


def rollout_config_defaults() -> dict:
    """``{key: default}`` for ``Serving.fleet.rollout``."""
    return _dataclass_defaults(RolloutConfig)


@dataclasses.dataclass
class FleetConfig:
    """Fleet-router knobs.

    * ``replicas`` — how many replica processes a fleet deployment boots
      (the router itself serves however many replicas are attached; this
      knob sizes deployments).
    * ``budget_interactive`` / ``budget_batch`` / ``budget_best_effort`` —
      per-priority-class admission queue budgets. A class at budget sheds
      NEW arrivals of that class with a typed ``QueueFullError`` while the
      other classes keep admitting — under overload best-effort saturates
      and sheds first, interactive keeps flowing.
    * ``cache_bytes`` — byte budget of the router's content-addressed
      answer cache (0 disables).
      Keyed on canonicalized graph bytes + model + quant flag, so
      duplicate molecules under heavy traffic cost zero replica compute.
    * ``auth`` — shared-secret token stamped on every replica round-trip
      (a misconfiguration guard; an auth mismatch is loud, never
      failed over).
    * ``peer_timeout`` — connect/read deadline per replica socket; the
      watchdog severs round-trips at ~1.25x this, so even a
      byte-dribbling replica cannot park a request.
    * ``probe_interval`` / ``quarantine_base_s`` / ``quarantine_cap_s`` —
      the quarantine and doubling re-probe clock of replica failover.
    * ``inflight_per_replica`` — concurrent round-trips the router keeps
      open per replica (the replica's own micro-batcher coalesces them);
      also bounds the dispatch window that least-loaded routing balances.
    * ``quarantine_jitter`` — random spread (fraction of the backoff) added
      to each quarantine re-probe deadline so multiple clients don't
      re-probe a recovering replica in the same instant (0 = the old
      synchronized doubling clock).
    * ``boot_timeout_s`` — how long ``spawn_replica`` waits for a worker's
      ready file (which it writes after its CUDA-graph warm-up) before
      declaring the boot dead.
    * ``serialized_boot`` — the JAX package's boot from serialized
      executables; accepted for its configs, read by nothing here.
    * ``autoscale`` / ``rollout`` — nested control-plane blocks; see
      :class:`AutoscalerConfig` and :class:`RolloutConfig`.
    """

    replicas: int = 2
    budget_interactive: int = 256
    budget_batch: int = 128
    budget_best_effort: int = 64
    cache_bytes: int = 33_554_432  # 32 MiB
    auth: str | None = None
    peer_timeout: float = 30.0
    probe_interval: float = 0.5
    quarantine_base_s: float = 0.5
    quarantine_cap_s: float = 8.0
    inflight_per_replica: int = 2
    quarantine_jitter: float = 0.25
    boot_timeout_s: float = 300.0
    serialized_boot: bool = True
    autoscale: dict = dataclasses.field(default_factory=autoscaler_config_defaults)
    rollout: dict = dataclasses.field(default_factory=rollout_config_defaults)

    @staticmethod
    def from_config(config: "dict | FleetConfig | None") -> "FleetConfig":
        """Accepts a FleetConfig (copied), a full config dict (reads
        ``Serving.fleet``, absent = defaults), the ``Serving`` block, or
        the fleet block itself — recognized by its field names; unknown
        fields raise instead of silently falling back to defaults."""
        if isinstance(config, FleetConfig):
            return dataclasses.replace(config)
        config = config or {}
        if "Serving" in config:
            # full config: its Serving.fleet block, absent = defaults
            serving = config["Serving"]
            if not isinstance(serving, dict):
                raise ValueError(
                    f"Serving must be a dict, got {type(serving).__name__}"
                )
            block = serving.get("fleet") or {}
        elif "fleet" in config:
            block = config["fleet"]  # the Serving block itself
        else:
            # the fleet block directly — recognized by its field names, so
            # a typo'd block raises instead of silently using defaults
            known = fleet_config_defaults()
            if config and not any(k in known for k in config):
                raise ValueError(
                    f"unrecognized fleet config keys {sorted(config)}; "
                    f"expected Serving.fleet fields {sorted(known)}"
                )
            block = config
        if not isinstance(block, dict):
            raise ValueError(
                f"Serving.fleet must be a dict, got {type(block).__name__}"
            )
        return FleetConfig(**block)


    def validate(self) -> "FleetConfig":
        """Range-check every field; the ONE implementation behind both the
        schema's nested ``Serving.fleet`` validation and direct router
        construction."""
        if int(self.replicas) < 1:
            raise ValueError(
                f"Serving.fleet.replicas must be >= 1, got {self.replicas}"
            )
        for cls in PRIORITY_CLASSES:
            key = f"budget_{cls}"
            if int(getattr(self, key)) < 1:
                raise ValueError(
                    f"Serving.fleet.{key} must be >= 1, got "
                    f"{getattr(self, key)}"
                )
        if int(self.cache_bytes) < 0:
            raise ValueError(
                "Serving.fleet.cache_bytes must be >= 0 (0 disables the "
                f"answer cache), got {self.cache_bytes}"
            )
        if self.auth is not None and not isinstance(self.auth, str):
            raise ValueError(
                f"Serving.fleet.auth must be a string token or null, got "
                f"{type(self.auth).__name__}"
            )
        for key in ("peer_timeout", "probe_interval", "quarantine_base_s",
                    "quarantine_cap_s"):
            if float(getattr(self, key)) <= 0:
                raise ValueError(
                    f"Serving.fleet.{key} must be > 0, got "
                    f"{getattr(self, key)}"
                )
        if int(self.inflight_per_replica) < 1:
            raise ValueError(
                "Serving.fleet.inflight_per_replica must be >= 1, got "
                f"{self.inflight_per_replica}"
            )
        if float(self.quarantine_jitter) < 0:
            raise ValueError(
                "Serving.fleet.quarantine_jitter must be >= 0 (0 disables "
                f"re-probe jitter), got {self.quarantine_jitter}"
            )
        if float(self.boot_timeout_s) <= 0:
            raise ValueError(
                "Serving.fleet.boot_timeout_s must be > 0, got "
                f"{self.boot_timeout_s}"
            )
        # The nested control-plane blocks validate through their own
        # dataclasses; unknown keys inside them are rejected HERE so a
        # typo'd autoscale knob fails at config load, not mid-incident.
        for key, defaults_fn, cls in (
            ("autoscale", autoscaler_config_defaults, AutoscalerConfig),
            ("rollout", rollout_config_defaults, RolloutConfig),
        ):
            block = getattr(self, key) or {}
            if not isinstance(block, dict):
                raise ValueError(
                    f"Serving.fleet.{key} must be a dict, got "
                    f"{type(block).__name__}"
                )
            unknown = set(block) - set(defaults_fn())
            if unknown:
                raise ValueError(
                    f"Unknown Serving.fleet.{key} key(s) {sorted(unknown)}; "
                    f"known: {sorted(defaults_fn())}"
                )
            cls(**block).validate()
        return self

    def budget(self, priority: str) -> int:
        return int(getattr(self, f"budget_{priority}"))

    def autoscaler_config(self) -> AutoscalerConfig:
        """The nested ``autoscale`` block as a typed config."""
        return AutoscalerConfig.from_config({"autoscale": dict(self.autoscale or {})})

    def rollout_config(self) -> RolloutConfig:
        """The nested ``rollout`` block as a typed config."""
        return RolloutConfig.from_config({"rollout": dict(self.rollout or {})})


def fleet_config_defaults() -> dict:
    """``{config key: default}`` for the ``Serving.fleet`` block — derived
    from ``dataclasses.fields`` so a future field cannot silently drop out
    of the schema/validation plumbing (nested blocks come from their own
    ``default_factory``)."""
    return _dataclass_defaults(FleetConfig)


__all__ = [
    "AutoscalerConfig",
    "FleetConfig",
    "PRIORITY_CLASSES",
    "RolloutConfig",
    "autoscaler_config_defaults",
    "fleet_config_defaults",
    "rollout_config_defaults",
]
