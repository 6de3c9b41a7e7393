"""Datapoints and datasets (reference data/data.py:54-534).

The port's copy of polymer_chemprop_tpu data/datapoint.py: a
MoleculeDatapoint owns its SMILES (one per molecule position), targets
(None = missing), a loss weight, the input CSV row, and the optional extra
inputs: molecule-level features (from files and/or features generators),
one-hot spectra phases, per-atom features or descriptors and per-bond
features, each with NaN set to 0 and a raw copy for re-normalization. A
MoleculeDataset adds the accessors and the target and feature scaling the
training layer uses; scaling runs in float64 as in the JAX package, so the
batches of the two packages are equal bit for bit. Graph featurization is
cached per (smiles, config) like the reference's SMILES_TO_GRAPH cache
(data.py:16-51); datapoints with extra atom or bond features are not
cached.
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
    """One training example: SMILES list (multi-molecule datapoints),
    targets, weight, extra features (reference data.py:54-230)."""

    def __init__(self,
                 smiles: List[str],
                 targets: Optional[List[Optional[float]]] = None,
                 row=None,
                 data_weight: float = 1.0,
                 features: Optional[np.ndarray] = None,
                 features_generators: Optional[List[str]] = None,
                 atom_features: Optional[np.ndarray] = None,
                 atom_descriptors: Optional[np.ndarray] = None,
                 bond_features: Optional[np.ndarray] = None,
                 phase_features: Optional[np.ndarray] = None):
        self.smiles = smiles
        self.phase_features = phase_features
        self.targets = targets
        self.row = row
        self.data_weight = data_weight
        self.features = features
        self.atom_features = atom_features
        self.atom_descriptors = atom_descriptors
        self.bond_features = bond_features

        if features_generators is not None:
            from ..features.generators import (generator_input_smiles,
                                               get_features_generator)
            feats = [] if self.features is None else [self.features]
            for fg_name in features_generators:
                fg = get_features_generator(fg_name)
                for s in self.smiles:
                    # reaction SMILES: featurize the REACTANT side
                    # (reference data.py:120-122 uses m[0] of the tuple);
                    # polymer strings: featurize the monomer SMILES —
                    # the split is the shared helper so the batch
                    # precompute cache keys always match
                    feats.append(fg(generator_input_smiles(s)))
            self.features = np.concatenate(feats) if feats else None

        # NaN -> 0 fixes (reference data.py:128-143)
        if self.features is not None:
            self.features = np.where(np.isnan(np.asarray(self.features, dtype=float)),
                                     0.0, self.features)
        for attr in ("atom_features", "atom_descriptors", "bond_features"):
            v = getattr(self, attr)
            if v is not None:
                setattr(self, attr, np.where(np.isnan(np.asarray(v, dtype=float)), 0.0, v))

        # raw copies for re-normalization (reference data.py:145-148)
        self.raw_features = self.features
        self.raw_targets = self.targets
        self.raw_atom_features = self.atom_features
        self.raw_atom_descriptors = self.atom_descriptors
        self.raw_bond_features = self.bond_features

    @property
    def num_tasks(self) -> Optional[int]:
        return len(self.targets) if self.targets is not None else None

    def set_targets(self, targets) -> None:
        self.targets = targets

    def set_features(self, features) -> None:
        self.features = features

    def extend_features(self, features) -> None:
        self.features = (np.concatenate([self.features, features])
                         if self.features is not None else features)

    def reset_features_and_targets(self) -> None:
        self.features = self.raw_features
        self.targets = self.raw_targets
        self.atom_features = self.raw_atom_features
        self.atom_descriptors = self.raw_atom_descriptors
        self.bond_features = self.raw_bond_features

    def mol_graphs(self, config: FeaturizationConfig) -> List[MolGraph]:
        """Featurize each molecule position, with process-wide caching."""
        out = []
        for i, s in enumerate(self.smiles):
            af = self.atom_features if i == 0 else None
            bf = self.bond_features if i == 0 else None
            cacheable = af is None and bf is None
            key = (s, config)
            g = _GRAPH_CACHE.get(key) if (_CACHE_ENABLED and cacheable) else None
            if g is None:
                g = MolGraph(s, config, atom_features_extra=af,
                             bond_features_extra=bf)
                if _CACHE_ENABLED and cacheable \
                        and len(_GRAPH_CACHE) < CACHE_CUTOFF:
                    with _CACHE_LOCK:
                        _GRAPH_CACHE[key] = g
            out.append(g)
        return out


class MoleculeDataset:
    """List of datapoints + normalization API (reference data.py:233-534)."""

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

    @property
    def datapoints(self) -> List[MoleculeDatapoint]:
        return self._data

    def smiles(self, flatten: bool = False):
        if flatten:
            return [s for d in self._data for s in d.smiles]
        return [d.smiles for d in self._data]

    def targets(self) -> List[List[Optional[float]]]:
        return [d.targets for d in self._data]

    def set_targets(self, targets: List[List[Optional[float]]]) -> None:
        assert len(targets) == len(self._data)
        for d, t in zip(self._data, targets):
            d.set_targets(t)

    def data_weights(self) -> List[float]:
        return [d.data_weight for d in self._data]

    def features(self) -> Optional[List[np.ndarray]]:
        if len(self._data) == 0 or self._data[0].features is None:
            return None
        return [d.features for d in self._data]

    def phase_features(self) -> Optional[List[np.ndarray]]:
        """One-hot spectra phase per datapoint (reference data.py:327-336)."""
        if len(self._data) == 0 or self._data[0].phase_features is None:
            return None
        return [d.phase_features for d in self._data]

    def atom_descriptors(self):
        if len(self._data) == 0 or self._data[0].atom_descriptors is None:
            return None
        return [d.atom_descriptors for d in self._data]

    def features_size(self) -> int:
        f = self.features()
        return len(f[0]) if f is not None else 0

    def atom_descriptors_size(self) -> int:
        d = self.atom_descriptors()
        return d[0].shape[1] if d is not None else 0

    @property
    def num_tasks(self) -> Optional[int]:
        return self._data[0].num_tasks if self._data else None

    def normalize_features(self, scaler: Optional[StandardScaler] = None,
                           replace_nan_token: float = 0.0,
                           scale_atom_descriptors: bool = False,
                           scale_bond_features: bool = False
                           ) -> Optional[StandardScaler]:
        """Fit-or-apply feature scaling (reference data.py:431-482)."""
        if len(self._data) == 0:
            return None
        if scale_atom_descriptors:
            if self._data[0].atom_descriptors is not None:
                stack = np.vstack([d.raw_atom_descriptors for d in self._data])
            elif self._data[0].atom_features is not None:
                stack = np.vstack([d.raw_atom_features for d in self._data])
            else:
                return None
        elif scale_bond_features:
            if self._data[0].bond_features is None:
                return None
            stack = np.vstack([d.raw_bond_features for d in self._data])
        else:
            if self._data[0].features is None:
                return None
            stack = np.vstack([d.raw_features for d in self._data])
        if scaler is None:
            scaler = StandardScaler(replace_nan_token=replace_nan_token).fit(stack)
        if scale_atom_descriptors and self._data[0].atom_descriptors is not None:
            for d in self._data:
                d.atom_descriptors = scaler.transform(d.raw_atom_descriptors)
        elif scale_atom_descriptors and self._data[0].atom_features is not None:
            for d in self._data:
                d.atom_features = scaler.transform(d.raw_atom_features)
        elif scale_bond_features:
            for d in self._data:
                d.bond_features = scaler.transform(d.raw_bond_features)
        else:
            for d in self._data:
                d.set_features(scaler.transform(d.raw_features.reshape(1, -1))[0])
        return scaler

    def normalize_targets(self) -> StandardScaler:
        """Fit a target scaler on non-missing entries and apply
        (reference data.py:484-500)."""
        targets = [d.raw_targets for d in self._data]
        X = np.array([[np.nan if t is None else t for t in row] for row in targets],
                     dtype=float)
        scaler = StandardScaler().fit(X)
        scaled = scaler.transform(X)
        self.set_targets([[None if np.isnan(v) else float(v) for v in row]
                          for row in scaled])
        return scaler

    def reset_features_and_targets(self) -> None:
        for d in self._data:
            d.reset_features_and_targets()
