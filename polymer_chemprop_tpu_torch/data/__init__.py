"""Data layer: datapoints, datasets, CSV ingest and the batch loader."""

from .csv_io import (
    get_data,
    get_data_from_smiles,
    get_header,
    get_task_names,
    partition_valid,
    preprocess_smiles_columns,
)
from .datapoint import CACHE_CUTOFF, MoleculeDatapoint, MoleculeDataset
from .loader import DeviceBatch, MoleculeDataLoader
from .scaler import StandardScaler

__all__ = [
    "CACHE_CUTOFF", "DeviceBatch", "MoleculeDataLoader", "MoleculeDatapoint",
    "MoleculeDataset", "StandardScaler", "get_data",
    "get_data_from_smiles", "get_header", "get_task_names",
    "partition_valid", "preprocess_smiles_columns",
]
