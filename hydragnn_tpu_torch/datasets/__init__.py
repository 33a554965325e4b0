"""Datasets generated in memory: the deterministic BCC fixture."""

from .synthetic import deterministic_graph_data  # noqa: F401

__all__ = ["deterministic_graph_data"]
