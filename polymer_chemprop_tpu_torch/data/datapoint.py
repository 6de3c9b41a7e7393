"""Datapoints and datasets (reference data/data.py:54-534).

The port's copy of polymer_chemprop_tpu data/datapoint.py without the
extra-feature inputs: a MoleculeDatapoint owns its SMILES (one per molecule
position), targets (None = missing), a loss weight and the input CSV row;
a MoleculeDataset adds the target accessors and normalization the training
layer uses. Graph featurization is cached per (smiles, config) like the
reference's SMILES_TO_GRAPH cache (data.py:16-51), so epochs and ensemble
members featurize each molecule once.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..features import FeaturizationConfig, MolGraph
from .scaler import StandardScaler

CACHE_CUTOFF = 10000  # reference run_training.py:170-175

_GRAPH_CACHE: Dict[tuple, MolGraph] = {}
_CACHE_LOCK = threading.Lock()
_CACHE_ENABLED = True


def set_cache_graph(enabled: bool) -> None:
    global _CACHE_ENABLED
    _CACHE_ENABLED = enabled


def empty_cache() -> None:
    with _CACHE_LOCK:
        _GRAPH_CACHE.clear()


class MoleculeDatapoint:
    """One input row: SMILES list (multi-molecule datapoints), targets,
    loss weight and the CSV row it came from (reference data.py:54-230)."""

    def __init__(self, smiles: List[str],
                 targets: Optional[List[Optional[float]]] = None,
                 row=None, data_weight: float = 1.0):
        self.smiles = smiles
        self.targets = targets
        self.row = row
        self.data_weight = data_weight
        # raw copy for re-normalization (reference data.py:145-148)
        self.raw_targets = targets

    @property
    def num_tasks(self) -> Optional[int]:
        return len(self.targets) if self.targets is not None else None

    def set_targets(self, targets) -> None:
        self.targets = targets

    def reset_features_and_targets(self) -> None:
        self.targets = self.raw_targets

    def mol_graphs(self, config: FeaturizationConfig) -> List[MolGraph]:
        """Featurize each molecule position, with process-wide caching."""
        out = []
        for s in self.smiles:
            key = (s, config)
            g = _GRAPH_CACHE.get(key) if _CACHE_ENABLED else None
            if g is None:
                g = MolGraph(s, config)
                if _CACHE_ENABLED and len(_GRAPH_CACHE) < CACHE_CUTOFF:
                    with _CACHE_LOCK:
                        _GRAPH_CACHE[key] = g
            out.append(g)
        return out


class MoleculeDataset:
    """List of datapoints (reference data.py:233-534)."""

    def __init__(self, data: Sequence[MoleculeDatapoint]):
        self._data = list(data)

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return MoleculeDataset(self._data[idx])
        return self._data[idx]

    def __iter__(self):
        return iter(self._data)

    def smiles(self, flatten: bool = False):
        if flatten:
            return [s for d in self._data for s in d.smiles]
        return [d.smiles for d in self._data]

    def targets(self) -> List[Optional[List[Optional[float]]]]:
        return [d.targets for d in self._data]

    def set_targets(self, targets: List[List[Optional[float]]]) -> None:
        assert len(targets) == len(self._data)
        for d, t in zip(self._data, targets):
            d.set_targets(t)

    def data_weights(self) -> List[float]:
        return [d.data_weight for d in self._data]

    @property
    def num_tasks(self) -> Optional[int]:
        return self._data[0].num_tasks if self._data else None

    def normalize_targets(self) -> StandardScaler:
        """Fit a target scaler on non-missing entries and apply
        (reference data.py:484-500)."""
        targets = [d.raw_targets for d in self._data]
        X = np.array([[np.nan if t is None else t for t in row]
                      for row in targets], dtype=float)
        scaler = StandardScaler().fit(X)
        scaled = scaler.transform(X)
        self.set_targets([[None if np.isnan(v) else float(v) for v in row]
                          for row in scaled])
        return scaler

    def reset_features_and_targets(self) -> None:
        for d in self._data:
            d.reset_features_and_targets()
