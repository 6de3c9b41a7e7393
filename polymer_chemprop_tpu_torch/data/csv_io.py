"""CSV ingestion (reference data/utils.py:53-389).

The port's copy of polymer_chemprop_tpu data/csv_io.py: SMILES columns,
task names, targets, per-datapoint loss weights, the validity parse, the
extra inputs (molecule feature files, features generators, one-hot spectra
phases, per-atom descriptor and per-bond feature files) and CSV/SMILES-list
datasets. The ``rdkit_2d`` generators featurize a whole dataset in one
batched call of the C++ engine, whose parse verdicts then stand in for the
Python validity parse of standard strings, exactly where the JAX package
reuses them.
"""

from __future__ import annotations

import csv
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np

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
             features_path: Optional[Sequence[str]] = None,
             features_generators: Optional[Sequence[str]] = None,
             data_weights_path: Optional[str] = None,
             max_data_size: Optional[int] = None,
             skip_invalid_smiles: bool = True,
             store_row: bool = False,
             atom_descriptors: Optional[str] = None,
             atom_descriptors_path: Optional[str] = None,
             bond_features_path: Optional[str] = None,
             phase_features_path: Optional[str] = None) -> MoleculeDataset:
    """CSV -> MoleculeDataset (reference data/utils.py:177-355)."""
    config = config or FeaturizationConfig()
    smiles_columns = preprocess_smiles_columns(path, smiles_columns,
                                               number_of_molecules)
    task_names = get_task_names(path, smiles_columns, target_columns,
                                ignore_columns, number_of_molecules)
    max_data_size = max_data_size or float("inf")

    features_data = None
    if features_path is not None:
        from ..features.utils import load_features
        feats = [load_features(p) for p in features_path]
        features_data = np.concatenate(feats, axis=1)

    # spectra phase features: validated one-hot rows, appended to the
    # molecule features AND kept separately for target masking
    # (reference data/utils.py:250-260)
    phase_data = None
    if phase_features_path is not None:
        from ..features.utils import load_features
        phase_data = np.asarray(load_features(phase_features_path))
        for d_phase in phase_data:
            if not (d_phase.sum() == 1 and np.count_nonzero(d_phase) == 1):
                raise ValueError("Phase features must be one-hot encoded.")
        features_data = phase_data if features_data is None else \
            np.concatenate([features_data, phase_data], axis=1)

    data_weights = get_data_weights(data_weights_path) \
        if data_weights_path is not None else None

    # per-atom/bond descriptor files (reference data/utils.py:309-327)
    atom_feats_list = bond_feats_list = None
    if atom_descriptors_path is not None or bond_features_path is not None:
        from ..features.utils import load_valid_atom_or_bond_features
        all_smiles = []
        with open(path) as f:
            for row in csv.DictReader(f):
                all_smiles.append(row[smiles_columns[0]])
        if atom_descriptors_path is not None:
            atom_feats_list = load_valid_atom_or_bond_features(
                atom_descriptors_path, all_smiles)
        if bond_features_path is not None:
            bond_feats_list = load_valid_atom_or_bond_features(
                bond_features_path, all_smiles)

    rows = []
    with open(path) as f:
        reader = csv.DictReader(f)
        for row in reader:
            if len(rows) >= max_data_size:
                break
            rows.append(row)

    # batch-featurize descriptor generators through the native engine in
    # ONE multi-threaded call before the per-datapoint loop (which calls
    # generators one molecule at a time, a batch-of-one each). Called
    # directly (not in a worker thread): the validation below consumes
    # the native parse verdicts, so there is nothing to overlap, and a
    # plain call surfaces engine exceptions.
    precomputed = False
    if features_generators and \
            {"rdkit_2d", "rdkit_2d_normalized"} & set(features_generators):
        from ..features.generators import precompute_rdkit2d_batch
        precompute_rdkit2d_batch(
            [row[c] for row in rows for c in smiles_columns])
        precomputed = True

    # validation parse (reference utils.py:158-174), memoized per unique
    # SMILES tuple. Standard strings the native engine just featurized
    # are known-parseable (the native parser accepts exactly the same
    # grammar), so the redundant Python re-parse is
    # skipped for them; reaction/polymer strings always re-parse (the
    # engine saw only the reactant/monomer side), and explicit_h configs
    # always re-parse (the engine's verdicts are for keep_h=False).
    keep = None
    if skip_invalid_smiles:
        native_ok = None
        if precomputed and not config.reaction and not config.polymer \
                and not config.explicit_h:
            from ..features.generators import _PRECOMPUTED_RDKIT2D
            native_ok = _PRECOMPUTED_RDKIT2D
        memo: dict = {}
        keep = []
        for row in rows:
            s = tuple(row[c] for c in smiles_columns)
            v = memo.get(s)
            if v is None:
                if native_ok is not None and all(
                        x in native_ok and "|" not in x and ">" not in x
                        for x in s):
                    v = True
                else:
                    v = _parseable(list(s), config)
                memo[s] = v
            keep.append(v)

    datapoints = []
    for i, row in enumerate(rows):
        smiles = [row[c] for c in smiles_columns]
        targets = []
        for t in task_names:
            v = row[t]
            targets.append(float(v) if v not in ("", "nan") else None)
        af = atom_feats_list[i] if atom_feats_list is not None else None
        datapoints.append(MoleculeDatapoint(
            smiles=smiles,
            targets=targets,
            row=OrderedDict(row) if store_row else None,
            data_weight=data_weights[i] if data_weights is not None else 1.0,
            features=features_data[i] if features_data is not None else None,
            features_generators=list(features_generators)
            if features_generators else None,
            atom_features=af if atom_descriptors == "feature" else None,
            atom_descriptors=af if atom_descriptors == "descriptor" else None,
            bond_features=bond_feats_list[i]
            if bond_feats_list is not None else None,
            phase_features=phase_data[i]
            if phase_data is not None else None,
        ))

    if skip_invalid_smiles:
        original = len(datapoints)
        datapoints = [d for d, k in zip(datapoints, keep) if k]
        if len(datapoints) < original:
            print(f"Warning: {original - len(datapoints)} SMILES are invalid.")

    return MoleculeDataset(datapoints)


def get_data_from_smiles(smiles: List[List[str]],
                         config: Optional[FeaturizationConfig] = None,
                         skip_invalid_smiles: bool = True,
                         features_generators: Optional[Sequence[str]] = None
                         ) -> MoleculeDataset:
    """SMILES lists -> dataset (reference data/utils.py:358-389)."""
    config = config or FeaturizationConfig()
    if features_generators and \
            {"rdkit_2d", "rdkit_2d_normalized"} & set(features_generators):
        from ..features.generators import precompute_rdkit2d_batch
        precompute_rdkit2d_batch([x for row in smiles for x in row])
    datapoints = [MoleculeDatapoint(smiles=s,
                                    features_generators=list(features_generators)
                                    if features_generators else None)
                  for s in smiles]
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
