"""Data layer: datapoints, datasets, CSV ingest, splits and the loader."""

from .csv_io import (
    get_data,
    get_data_from_smiles,
    get_data_weights,
    get_header,
    get_task_names,
    partition_valid,
    preprocess_smiles_columns,
    validate_dataset_type,
)
from .datapoint import (
    CACHE_CUTOFF,
    MoleculeDatapoint,
    MoleculeDataset,
    empty_cache,
    set_cache_graph,
)
from .loader import DeviceBatch, MoleculeDataLoader
from .scaler import StandardScaler
from .splits import scaffold_split, split_data

__all__ = [
    "CACHE_CUTOFF", "DeviceBatch", "MoleculeDataLoader", "MoleculeDatapoint",
    "MoleculeDataset", "StandardScaler", "empty_cache", "get_data",
    "get_data_from_smiles", "get_data_weights", "get_header",
    "get_task_names", "partition_valid", "preprocess_smiles_columns",
    "scaffold_split", "set_cache_graph", "split_data",
    "validate_dataset_type",
]
