"""In-memory data pipeline: selection, normalisation, geometric transforms
and descriptors, positional encodings, splits, loaders."""

from .encodings import attach_lap_pe, laplacian_pe  # noqa: F401
from .load_data import (  # noqa: F401
    apply_variables_of_interest,
    create_dataloaders,
    dataset_loading_and_splitting,
    normalize_features,
    split_dataset,
)
from .transforms import (  # noqa: F401
    attach_edge_lengths,
    composition_category,
    normalize_edge_lengths_global,
    normalize_rotation,
    point_pair_features,
    spherical_features,
    stratified_subsample,
)

__all__ = [
    "apply_variables_of_interest",
    "attach_edge_lengths",
    "attach_lap_pe",
    "composition_category",
    "create_dataloaders",
    "dataset_loading_and_splitting",
    "laplacian_pe",
    "normalize_edge_lengths_global",
    "normalize_features",
    "normalize_rotation",
    "point_pair_features",
    "spherical_features",
    "split_dataset",
    "stratified_subsample",
]
