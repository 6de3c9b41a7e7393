"""Datapoints and datasets for prediction (reference data/data.py:54-534).

The port's copy of polymer_chemprop_tpu data/datapoint.py, cut to what
prediction needs: a MoleculeDatapoint owns its SMILES (one per molecule
position), optional targets and the input CSV row. Graph featurization is
cached per (smiles, config) like the reference's SMILES_TO_GRAPH cache
(data.py:16-51), so an ensemble featurizes each molecule once.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from ..features import FeaturizationConfig, MolGraph

CACHE_CUTOFF = 10000  # reference run_training.py:170-175

_GRAPH_CACHE: Dict[tuple, MolGraph] = {}
_CACHE_LOCK = threading.Lock()


class MoleculeDatapoint:
    """One input row: SMILES list (multi-molecule datapoints), targets and
    the CSV row it came from (reference data.py:54-230)."""

    def __init__(self, smiles: List[str],
                 targets: Optional[List[Optional[float]]] = None,
                 row=None):
        self.smiles = smiles
        self.targets = targets
        self.row = row

    def mol_graphs(self, config: FeaturizationConfig) -> List[MolGraph]:
        """Featurize each molecule position, with process-wide caching."""
        out = []
        for s in self.smiles:
            key = (s, config)
            g = _GRAPH_CACHE.get(key)
            if g is None:
                g = MolGraph(s, config)
                if len(_GRAPH_CACHE) < CACHE_CUTOFF:
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
