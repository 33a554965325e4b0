"""Validated config of the bulk-screening engine (``screen/``).

Counterpart of ``hydragnn_tpu/screen/config.py``, the same fields and
defaults: the schema validator (``config.schema.update_config``) fills the
top-level ``Screening`` block from :class:`ScreeningConfig`'s fields, and
the ``HYDRAGNN_SCREEN_*`` flags win over it (:meth:`ScreeningConfig.apply_env`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ScreeningConfig:
    """Knobs for one bulk screen (see ``screen.engine.BulkScreener``).

    ``topk``/``prefetch`` have runtime flag overrides
    (``HYDRAGNN_SCREEN_TOPK`` / ``HYDRAGNN_SCREEN_PREFETCH``) applied by
    :meth:`apply_env` — flags win over config, config over defaults, the
    same precedence every other subsystem uses."""

    # ranked candidates kept; ordering is (score desc, index asc)
    topk: int = 16
    # graphs per dispatched block (= n_graph - 1 of every derived bucket)
    batch_size: int = 32
    # pad buckets derived per compute_pad_buckets (1 = worst-case only)
    max_buckets: int = 4
    # blocks staged ahead by the background fetch/collate thread; 0 = sync
    prefetch: int = 2
    # which output head carries the screening score (must be a graph head)
    score_head: int = 0
    # column of that head used as the scalar score
    score_col: int = 0
    # >0: population-ensemble variance above this flags a score untrusted
    ensemble_variance_max: float = 0.0
    # emit blocks bucket-major (grouped by bucket) instead of stream order;
    # either way every non-tail block is full for its bucket
    bucket_major: bool = True
    # write the resume sidecar every N blocks (1 = after every block)
    checkpoint_every: int = 1

    def validate(self) -> "ScreeningConfig":
        if self.topk < 1:
            raise ValueError(f"Screening.topk must be >= 1, got {self.topk}")
        if self.batch_size < 1:
            raise ValueError(
                f"Screening.batch_size must be >= 1, got {self.batch_size}"
            )
        if self.max_buckets < 1:
            raise ValueError(
                f"Screening.max_buckets must be >= 1, got {self.max_buckets}"
            )
        if self.prefetch < 0:
            raise ValueError(
                f"Screening.prefetch must be >= 0, got {self.prefetch}"
            )
        if self.score_head < 0 or self.score_col < 0:
            raise ValueError(
                "Screening.score_head/score_col must be >= 0, got "
                f"{self.score_head}/{self.score_col}"
            )
        if self.ensemble_variance_max < 0:
            raise ValueError(
                "Screening.ensemble_variance_max must be >= 0, got "
                f"{self.ensemble_variance_max}"
            )
        if self.checkpoint_every < 1:
            raise ValueError(
                "Screening.checkpoint_every must be >= 1, got "
                f"{self.checkpoint_every}"
            )
        return self

    def apply_env(self) -> "ScreeningConfig":
        """Apply the ``HYDRAGNN_SCREEN_*`` flag overrides (flags win)."""
        from ..utils import flags

        topk = flags.get(flags.SCREEN_TOPK)
        if topk is not None:
            self.topk = int(topk)
        prefetch = flags.get(flags.SCREEN_PREFETCH)
        if prefetch is not None:
            self.prefetch = int(prefetch)
        return self.validate()


def screening_config_defaults() -> dict:
    return dataclasses.asdict(ScreeningConfig())


def screening_config_from(config: dict) -> ScreeningConfig:
    """Build from an augmented config dict's (already validated)
    ``Screening`` block, then apply flag overrides."""
    block = dict(config.get("Screening", {}))
    cfg = ScreeningConfig(**{
        k: block.get(k, v) for k, v in screening_config_defaults().items()
    })
    return cfg.validate().apply_env()


__all__ = [
    "ScreeningConfig",
    "screening_config_defaults",
    "screening_config_from",
]
