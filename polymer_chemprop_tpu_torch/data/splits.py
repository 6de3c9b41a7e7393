"""Dataset splitters (reference data/utils.py:392-549 + data/scaffold.py).

Implements the same split types with the same seeded shuffling algorithm
(``random.Random(seed).shuffle``), so given identical input ordering the
partitions match the reference exactly — which is what lets the golden
-score integration tests carry over.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict
from random import Random
from typing import List, Optional, Tuple

import numpy as np

from ..chem.scaffold import scaffold_key
from .datapoint import MoleculeDataset

Splits = Tuple[MoleculeDataset, MoleculeDataset, MoleculeDataset]


def split_data(data: MoleculeDataset,
               split_type: str = "random",
               sizes: Tuple[float, float, float] = (0.8, 0.1, 0.1),
               seed: int = 0,
               num_folds: int = 1,
               folds_file: Optional[str] = None,
               val_fold_index: Optional[int] = None,
               test_fold_index: Optional[int] = None,
               crossval_index_sets: Optional[list] = None,
               crossval_index_dir: Optional[str] = None,
               key_molecule_index: int = 0) -> Splits:
    if not (len(sizes) == 3 and abs(sum(sizes) - 1) < 1e-9):
        raise ValueError("Valid split sizes must sum to 1 and must have "
                         "three sizes: train, validation, and test.")
    random = Random(seed)

    if split_type == "crossval":
        # predefined fold-index files: crossval_index_sets[seed] holds three
        # lists of file indices; each {i}.pkl in crossval_index_dir holds the
        # datapoint indices of one fold (reference data/utils.py:426-439)
        index_set = crossval_index_sets[seed]
        data_split = []
        for split in range(3):
            split_indices = []
            for index in index_set[split]:
                with open(os.path.join(crossval_index_dir, f"{index}.pkl"),
                          "rb") as rf:
                    split_indices.extend(pickle.load(rf))
            data_split.append(MoleculeDataset([data[i] for i in split_indices]))
        return tuple(data_split)  # type: ignore[return-value]

    if split_type in ("cv", "cv-no-test"):
        if num_folds <= 1 or num_folds > len(data):
            raise ValueError("Number of folds for cross-validation must be "
                             "between 2 and len(data), inclusive.")
        random = Random(0)
        indices = np.repeat(np.arange(num_folds),
                            1 + len(data) // num_folds)[:len(data)]
        random.shuffle(indices)
        test_index = seed % num_folds
        val_index = (seed + 1) % num_folds
        train, val, test = [], [], []
        for d, index in zip(data, indices):
            if index == test_index and split_type != "cv-no-test":
                test.append(d)
            elif index == val_index:
                val.append(d)
            else:
                train.append(d)
        return MoleculeDataset(train), MoleculeDataset(val), MoleculeDataset(test)

    if split_type == "index_predetermined":
        split_indices = crossval_index_sets[seed]
        if len(split_indices) != 3:
            raise ValueError("Split indices must have three splits: train, "
                             "validation, and test")
        return tuple(MoleculeDataset([data[i] for i in split_indices[j]])
                     for j in range(3))  # type: ignore[return-value]

    if split_type == "predetermined":
        if not val_fold_index and sizes[2] != 0:
            raise ValueError("Test size must be zero since test set is "
                             "created separately and we want to put all "
                             "other data in train and validation")
        assert folds_file is not None and test_fold_index is not None
        with open(folds_file, "rb") as f:
            try:
                all_fold_indices = pickle.load(f)
            except UnicodeDecodeError:
                f.seek(0)
                all_fold_indices = pickle.load(f, encoding="latin1")
        folds = [[data[i] for i in fold] for fold in all_fold_indices]
        test = folds[test_fold_index]
        if val_fold_index is not None:
            val = folds[val_fold_index]
            train = [d for i, fold in enumerate(folds)
                     if i not in (test_fold_index, val_fold_index) for d in fold]
        else:
            train_val = [d for i, fold in enumerate(folds)
                         if i != test_fold_index for d in fold]
            random.shuffle(train_val)
            train_size = int(sizes[0] * len(train_val))
            train = train_val[:train_size]
            val = train_val[train_size:]
        return MoleculeDataset(train), MoleculeDataset(val), MoleculeDataset(test)

    if split_type == "scaffold_balanced":
        return scaffold_split(data, sizes=sizes, balanced=True, seed=seed,
                              key_molecule_index=key_molecule_index)

    if split_type == "random_with_repeated_smiles":
        smiles_dict = defaultdict(set)
        for i, smiles in enumerate(data.smiles()):
            smiles_dict[smiles[key_molecule_index]].add(i)
        index_sets = list(smiles_dict.values())
        random.seed(seed)
        random.shuffle(index_sets)
        train, val, test = [], [], []
        train_size = int(sizes[0] * len(data))
        val_size = int(sizes[1] * len(data))
        for index_set in index_sets:
            if len(train) + len(index_set) <= train_size:
                train += index_set
            elif len(val) + len(index_set) <= val_size:
                val += index_set
            else:
                test += index_set
        return (MoleculeDataset([data[i] for i in train]),
                MoleculeDataset([data[i] for i in val]),
                MoleculeDataset([data[i] for i in test]))

    if split_type == "random":
        indices = list(range(len(data)))
        random.shuffle(indices)
        train_size = int(sizes[0] * len(data))
        train_val_size = int((sizes[0] + sizes[1]) * len(data))
        return (MoleculeDataset([data[i] for i in indices[:train_size]]),
                MoleculeDataset([data[i] for i in indices[train_size:train_val_size]]),
                MoleculeDataset([data[i] for i in indices[train_val_size:]]))

    raise ValueError(f'split_type "{split_type}" not supported.')


def scaffold_to_indices(smiles_list: List[str]) -> dict:
    """Map scaffold key -> set of indices (reference data/scaffold.py:32-50).
    Insertion order (first occurrence) is preserved as in the reference's
    defaultdict, which the balanced splitter's shuffle depends on."""
    d = defaultdict(set)
    for i, s in enumerate(smiles_list):
        d[scaffold_key(s)].add(i)
    return d


def scaffold_split(data: MoleculeDataset,
                   sizes: Tuple[float, float, float] = (0.8, 0.1, 0.1),
                   balanced: bool = False,
                   seed: int = 0,
                   key_molecule_index: int = 0) -> Splits:
    """Murcko-scaffold split (reference data/scaffold.py:53-130)."""
    assert abs(sum(sizes) - 1) < 1e-9
    train_size = sizes[0] * len(data)
    val_size = sizes[1] * len(data)
    test_size = sizes[2] * len(data)
    train, val, test = [], [], []

    sti = scaffold_to_indices([s[key_molecule_index] for s in data.smiles()])
    random = Random(seed)
    if balanced:
        index_sets = list(sti.values())
        big, small = [], []
        for index_set in index_sets:
            if len(index_set) > val_size / 2 or len(index_set) > test_size / 2:
                big.append(index_set)
            else:
                small.append(index_set)
        random.seed(seed)
        random.shuffle(big)
        random.shuffle(small)
        index_sets = big + small
    else:
        index_sets = sorted(sti.values(), key=len, reverse=True)

    for index_set in index_sets:
        if len(train) + len(index_set) <= train_size:
            train += index_set
        elif len(val) + len(index_set) <= val_size:
            val += index_set
        else:
            test += index_set

    return (MoleculeDataset([data[i] for i in train]),
            MoleculeDataset([data[i] for i in val]),
            MoleculeDataset([data[i] for i in test]))
