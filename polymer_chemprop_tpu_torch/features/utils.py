"""Feature file I/O (reference features/utils.py:11-107).

The port's copy of polymer_chemprop_tpu features/utils.py: .npz (key
'features'), .npy, .csv and pickled sparse formats for molecule-level
features, and .npz/.pkl/.sdf for per-atom/bond features. The .pkl
per-atom branch needs pandas and imports it only there.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import List

import numpy as np


def save_features(path: str, features: List[np.ndarray]) -> None:
    np.savez_compressed(path, features=features)


def load_features(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1]
    if ext == ".npz":
        return np.load(path)["features"]
    if ext == ".npy":
        return np.load(path)
    if ext in (".csv", ".txt"):
        with open(path) as f:
            reader = csv.reader(f)
            next(reader)
            return np.array([[float(v) for v in row] for row in reader])
    if ext in (".pkl", ".pckl", ".pickle"):
        with open(path, "rb") as f:
            feats = pickle.load(f)
        return np.array([np.squeeze(np.array(feat.todense())) for feat in feats])
    raise ValueError(f'Features path extension "{ext}" not supported.')


def load_valid_atom_or_bond_features(path: str, smiles: List[str]) -> List[np.ndarray]:
    """Per-molecule atom/bond feature arrays keyed by position or SMILES
    (reference features/utils.py:60-107)."""
    ext = os.path.splitext(path)[1]
    if ext == ".npz":
        container = np.load(path)
        features = [container[key] for key in container]
    elif ext in (".pkl", ".pckl", ".pickle"):
        import pandas as pd
        features_df = pd.read_pickle(path)
        if features_df.iloc[0, 0].ndim == 1:
            features = features_df.apply(lambda x: np.stack(x.tolist(), axis=1),
                                         axis=1).tolist()
        elif features_df.iloc[0, 0].ndim == 2:
            features = features_df.apply(lambda x: np.concatenate(x.tolist(), axis=1),
                                         axis=1).tolist()
        else:
            raise ValueError("Atom/bond descriptors input format not supported")
    elif ext == ".sdf":
        features = _load_sdf_descriptors(path, smiles)
    else:
        raise ValueError(f'Extension "{ext}" is not supported.')
    if len(features) != len(smiles):
        raise ValueError("The number of molecules/features mismatch")
    return features


def _load_sdf_descriptors(path: str, smiles: List[str]) -> List[np.ndarray]:
    """SDF atom-descriptor loading (reference features/utils.py:89-103).

    The reference loads the SDF with ``PandasTools.LoadSDF``, indexes by the
    per-record ``SMILES`` property, keeps the columns whose first-record value
    is a comma-separated string, reindexes by the input SMILES order, and
    stacks each column (one descriptor channel, one value per atom) into an
    ``(n_atoms, n_channels)`` array. We parse the SDF data fields directly.
    """
    records: dict = {}
    field_order: List[str] = []
    with open(path) as f:
        fields: dict = {}
        name = None
        value_lines: List[str] = []
        for raw in f:
            line = raw.rstrip("\r\n")
            if line.startswith("$$$$"):
                if name is not None:
                    fields[name] = "".join(value_lines)
                key = fields.get("SMILES")
                if key is not None and key not in records:
                    records[key] = fields
                    for fname in fields:
                        if fname not in field_order:
                            field_order.append(fname)
                fields, name, value_lines = {}, None, []
            elif line.startswith("> "):
                if name is not None:
                    fields[name] = "".join(value_lines)
                start, end = line.find("<"), line.rfind(">")
                name = line[start + 1:end] if 0 <= start < end else line[2:]
                value_lines = []
            elif name is not None:
                if line:
                    value_lines.append(line)
    if not records:
        raise ValueError(f"No SMILES-keyed records found in {path}")
    first = records[next(iter(records))]
    desc_cols = [c for c in field_order
                 if c not in ("ID", "SMILES")
                 and isinstance(first.get(c), str) and "," in first[c]]
    features = []
    for smi in smiles:
        rec = records.get(smi)
        if rec is None or any(c not in rec for c in desc_cols):
            raise ValueError(
                "Invalid custom atomic descriptors file, Nan found in data")
        cols = [np.array(rec[c].replace("\r", "").replace("\n", "")
                         .split(",")).astype(float) for c in desc_cols]
        features.append(np.stack(cols, axis=1))
    return features
