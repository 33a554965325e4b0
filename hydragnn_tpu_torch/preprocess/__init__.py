"""In-memory data pipeline: selection, normalisation, positional encodings,
splits, loaders."""

from .encodings import attach_lap_pe, laplacian_pe  # noqa: F401
from .load_data import (  # noqa: F401
    apply_variables_of_interest,
    create_dataloaders,
    dataset_loading_and_splitting,
    normalize_features,
    split_dataset,
)

__all__ = [
    "apply_variables_of_interest",
    "attach_lap_pe",
    "create_dataloaders",
    "dataset_loading_and_splitting",
    "laplacian_pe",
    "normalize_features",
    "split_dataset",
]
