"""CSV ingestion (reference data/utils.py:53-389).

The port's copy of polymer_chemprop_tpu data/csv_io.py: SMILES columns,
task names, targets, per-datapoint loss weights, the validity parse, and
CSV/SMILES-list datasets. Extra feature inputs (feature files, generators,
atom/bond descriptor files) are not on the port yet.
"""

from __future__ import annotations

import csv
from collections import OrderedDict
from typing import List, Optional, Sequence

from ..chem import parse_smiles
from ..features import FeaturizationConfig
from .datapoint import MoleculeDatapoint, MoleculeDataset


def get_header(path: str) -> List[str]:
    with open(path) as f:
        return next(csv.reader(f))


def preprocess_smiles_columns(path: str,
                              smiles_columns: Optional[Sequence[str]] = None,
                              number_of_molecules: int = 1) -> List[str]:
    """Resolve which columns hold SMILES (reference data/utils.py:24-50):
    default is the first ``number_of_molecules`` columns."""
    if smiles_columns is None:
        return get_header(path)[:number_of_molecules]
    smiles_columns = list(smiles_columns)
    header = get_header(path)
    for c in smiles_columns:
        if c not in header:
            raise ValueError(f"SMILES column {c} not found in {path}")
    return smiles_columns


def get_task_names(path: str,
                   smiles_columns: Optional[Sequence[str]] = None,
                   target_columns: Optional[Sequence[str]] = None,
                   ignore_columns: Optional[Sequence[str]] = None,
                   number_of_molecules: int = 1) -> List[str]:
    """Target column names (reference data/utils.py:53-98)."""
    if target_columns is not None:
        return list(target_columns)
    header = get_header(path)
    smiles_columns = preprocess_smiles_columns(path, smiles_columns,
                                               number_of_molecules)
    ignore = set(smiles_columns) | set(ignore_columns or [])
    return [c for c in header if c not in ignore]


def get_data_weights(path: str) -> List[float]:
    """Per-datapoint loss weights file (reference data/utils.py:101-119)."""
    weights = []
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            weights.append(float(row[0]))
    avg = sum(weights) / len(weights)
    weights = [w / avg for w in weights]
    if min(weights) < 0:
        raise ValueError("Data weights must be non-negative.")
    return weights


def _parseable(smiles: List[str], config: FeaturizationConfig) -> bool:
    for s in smiles:
        if config.reaction:
            parts = [s.split(">")[0], s.split(">")[-1]]
        elif config.polymer:
            parts = s.split("|")[0].split(".")
        else:
            parts = [s]
        for p in parts:
            if parse_smiles(p, keep_h=config.explicit_h, strict=False) is None:
                return False
    return True


def partition_valid(full_data: MoleculeDataset, config: FeaturizationConfig):
    """Split a dataset loaded with skip_invalid_smiles=False into the
    valid subset plus a full->valid index map (reference
    make_predictions.py:66-73 'Validating SMILES' step)."""
    full_to_valid = {}
    valid_points = []
    for i, d in enumerate(full_data):
        if _parseable(d.smiles, config):
            full_to_valid[i] = len(valid_points)
            valid_points.append(d)
    return full_to_valid, MoleculeDataset(valid_points)


def get_data(path: str,
             smiles_columns: Optional[Sequence[str]] = None,
             target_columns: Optional[Sequence[str]] = None,
             ignore_columns: Optional[Sequence[str]] = None,
             number_of_molecules: int = 1,
             config: Optional[FeaturizationConfig] = None,
             data_weights_path: Optional[str] = None,
             max_data_size: Optional[int] = None,
             skip_invalid_smiles: bool = True,
             store_row: bool = False) -> MoleculeDataset:
    """CSV -> MoleculeDataset (reference data/utils.py:177-355)."""
    config = config or FeaturizationConfig()
    smiles_columns = preprocess_smiles_columns(path, smiles_columns,
                                               number_of_molecules)
    task_names = get_task_names(path, smiles_columns, target_columns,
                                ignore_columns, number_of_molecules)
    max_data_size = max_data_size or float("inf")
    data_weights = get_data_weights(data_weights_path) \
        if data_weights_path is not None else None
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            if len(rows) >= max_data_size:
                break
            rows.append(row)
    datapoints = []
    for i, row in enumerate(rows):
        targets = [float(row[t]) if row[t] not in ("", "nan") else None
                   for t in task_names]
        datapoints.append(MoleculeDatapoint(
            smiles=[row[c] for c in smiles_columns], targets=targets,
            row=OrderedDict(row) if store_row else None,
            data_weight=data_weights[i] if data_weights is not None else 1.0))
    if skip_invalid_smiles:
        # validation parse (reference utils.py:158-174), memoized per
        # unique SMILES tuple
        memo: dict = {}
        keep = []
        for d in datapoints:
            key = tuple(d.smiles)
            if key not in memo:
                memo[key] = _parseable(d.smiles, config)
            keep.append(memo[key])
        original = len(datapoints)
        datapoints = [d for d, k in zip(datapoints, keep) if k]
        if len(datapoints) < original:
            print(f"Warning: {original - len(datapoints)} SMILES are invalid.")
    return MoleculeDataset(datapoints)


def get_data_from_smiles(smiles: List[List[str]],
                         config: Optional[FeaturizationConfig] = None,
                         skip_invalid_smiles: bool = True) -> MoleculeDataset:
    """SMILES lists -> dataset (reference data/utils.py:358-389)."""
    config = config or FeaturizationConfig()
    datapoints = [MoleculeDatapoint(smiles=s) for s in smiles]
    if skip_invalid_smiles:
        datapoints = [d for d in datapoints if _parseable(d.smiles, config)]
    return MoleculeDataset(datapoints)


def validate_dataset_type(data: MoleculeDataset, dataset_type: str) -> None:
    """Check targets match the dataset type (reference data/utils.py:584-599)."""
    target_set = {t for row in data.targets() for t in row if t is not None}
    classification = target_set <= {0, 1}
    if dataset_type == "classification" and not classification:
        raise ValueError("Classification data targets must only be 0 or 1 "
                         "(or None).")
    if dataset_type == "regression" and classification and len(target_set) > 0:
        import warnings
        warnings.warn("Regression data targets are all 0/1; did you mean "
                      "--dataset_type classification?")
