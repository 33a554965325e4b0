"""Precision policy and the predict step (training comes in a later slice)."""

from .step import KNOWN_PRECISIONS, make_predict_step, resolve_precision  # noqa: F401

__all__ = ["KNOWN_PRECISIONS", "make_predict_step", "resolve_precision"]
