"""In-memory data pipeline: selection, normalisation, splits, loaders."""

from .load_data import (  # noqa: F401
    apply_variables_of_interest,
    create_dataloaders,
    dataset_loading_and_splitting,
    normalize_features,
    split_dataset,
)

__all__ = [
    "apply_variables_of_interest",
    "create_dataloaders",
    "dataset_loading_and_splitting",
    "normalize_features",
    "split_dataset",
]
