"""Datasets generated in memory: the deterministic BCC fixture and the
Lennard-Jones MLIP fixture."""

from .lennard_jones import lennard_jones_data, lj_energy_forces  # noqa: F401
from .synthetic import deterministic_graph_data  # noqa: F401

__all__ = ["deterministic_graph_data", "lennard_jones_data", "lj_energy_forces"]
