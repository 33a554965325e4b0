"""Fleet serving: a multi-process RPC front end over ``PredictionServer``.

Counterpart of ``hydragnn_tpu/serve/fleet/``: N replica processes
(``replica.py``, each a ``PredictionServer`` booted from checkpoint paths
alone and warmed, CUDA graphs captured, before it advertises ready) behind
one :class:`~hydragnn_tpu_torch.serve.fleet.router.FleetRouter` on the
``utils.wire`` transport, with priority classes and per-class budgets,
deadline-aware shedding, least-loaded dispatch, health-checked failover, a
content-addressed answer cache, the SLO autoscaler and blue/green rollouts.

Attribute access is lazy (PEP 562): ``serve.server`` imports this package's
``config`` submodule, and an eager router import here would close an
import cycle back into ``serve.server``.
"""

from .config import (  # noqa: F401
    AutoscalerConfig,
    FleetConfig,
    PRIORITY_CLASSES,
    RolloutConfig,
    autoscaler_config_defaults,
    fleet_config_defaults,
    rollout_config_defaults,
)

_LAZY = {
    "AnswerCache": ".cache",
    "answer_key": ".cache",
    "canonical_sample_bytes": ".cache",
    "FleetRouter": ".router",
    "Autoscaler": ".autoscaler",
    "CanaryMismatchError": ".rollout",
    "blue_green_rollout": ".rollout",
    "run_canary": ".rollout",
    "ReplicaBootError": ".replica",
    "ReplicaHost": ".replica",
    "ReplicaProcess": ".replica",
    "spawn_replica": ".replica",
    "worker_main": ".replica",
    "write_samples_file": ".replica",
}

__all__ = [
    "AnswerCache",
    "Autoscaler",
    "AutoscalerConfig",
    "CanaryMismatchError",
    "FleetConfig",
    "FleetRouter",
    "PRIORITY_CLASSES",
    "ReplicaBootError",
    "ReplicaHost",
    "ReplicaProcess",
    "RolloutConfig",
    "answer_key",
    "autoscaler_config_defaults",
    "blue_green_rollout",
    "canonical_sample_bytes",
    "fleet_config_defaults",
    "rollout_config_defaults",
    "run_canary",
    "spawn_replica",
    "worker_main",
    "write_samples_file",
]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod, __name__), name)
