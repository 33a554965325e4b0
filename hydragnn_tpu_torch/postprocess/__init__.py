"""Output denormalisation, per-node unscaling and the LSMS
post-processing (formation Gibbs energy, compositional histogram cutoff)."""

from .lsms import (  # noqa: F401
    compositional_histogram_cutoff,
    compute_formation_enthalpy,
    convert_total_energy_to_formation_gibbs,
)
from .postprocess import (  # noqa: F401
    head_scales,
    output_denormalize,
    unscale_features_by_num_nodes,
    unscale_features_by_num_nodes_config,
)

__all__ = [
    "compositional_histogram_cutoff",
    "compute_formation_enthalpy",
    "convert_total_energy_to_formation_gibbs",
    "head_scales",
    "output_denormalize",
    "unscale_features_by_num_nodes",
    "unscale_features_by_num_nodes_config",
]
