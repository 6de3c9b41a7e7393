"""Split persistence (reference utils.py:619-728 save_smiles_splits).

Writes per-split SMILES CSVs, full-data CSVs, and a split_indices.pckl so
experiments are reproducible from artifacts alone.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Optional

from ..data import MoleculeDataset


def save_smiles_splits(save_dir: str,
                       train_data: Optional[MoleculeDataset] = None,
                       val_data: Optional[MoleculeDataset] = None,
                       test_data: Optional[MoleculeDataset] = None,
                       data_path: Optional[str] = None,
                       task_names=None,
                       smiles_columns=None) -> None:
    os.makedirs(save_dir, exist_ok=True)

    # map smiles -> original row index for split_indices.pckl
    index_map = {}
    if data_path and os.path.exists(data_path):
        with open(data_path) as f:
            reader = csv.DictReader(f)
            cols = smiles_columns or reader.fieldnames[:1]
            for i, row in enumerate(reader):
                key = tuple(row[c] for c in cols)
                index_map.setdefault(key, i)

    all_split_indices = []
    for name, dataset in [("train", train_data), ("val", val_data),
                          ("test", test_data)]:
        if dataset is None:
            continue
        with open(os.path.join(save_dir, f"{name}_smiles.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["smiles"])
            for d in dataset:
                w.writerow(d.smiles)
        with open(os.path.join(save_dir, f"{name}_full.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["smiles"] + list(task_names or []))
            for d in dataset:
                targets = d.raw_targets if d.raw_targets is not None else []
                w.writerow(list(d.smiles) +
                           ["" if t is None else t for t in targets])
        split_indices = []
        for d in dataset:
            idx = index_map.get(tuple(d.smiles))
            if idx is not None:
                split_indices.append(idx)
        all_split_indices.append(sorted(split_indices))

    with open(os.path.join(save_dir, "split_indices.pckl"), "wb") as f:
        pickle.dump(all_split_indices, f)
