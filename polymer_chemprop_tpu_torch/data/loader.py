"""Batch loader: dataset -> fixed-shape host arrays.

The port's copy of polymer_chemprop_tpu data/loader.py without the extra
feature inputs and the Pallas switches. By default each batch is
featurized and packed by the C++ library of native_ext.py (standard,
polymer and reaction configurations, with explicit or added hydrogens),
which is bit for bit the pure-Python path (``features/``); ``use_native=
False`` takes the Python path. Batches are made on a thread pool when
there is more than one (a ctypes call releases the GIL), and every batch
carries the dst-sorted bond layout of ops/sorted_aux.py. Every emitted
batch shares one padding envelope, sticky under reshuffling, so the
kernels see one shape per run.

Sampling mirrors MoleculeSampler (reference data.py:537-591): seeded
shuffle (``random.Random(seed)``, the same stream as the JAX package's
loader) and optional class_balance interleaving of positive/negative pairs.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from random import Random
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..features import FeaturizationConfig, batch_graphs, round_up
from .datapoint import MoleculeDataset


class DeviceBatch:
    """Host-side arrays of one batch, padded to ``batch_size`` rows."""

    def __init__(self, graph_arrays: List[Dict[str, np.ndarray]],
                 targets: np.ndarray, mask: np.ndarray,
                 data_weights: np.ndarray, size: int):
        self.graph_arrays = graph_arrays  # one dict per molecule position
        self.targets = targets            # (M, T) float32, 0 where missing
        self.mask = mask                  # (M, T) float32, 1 where present
        self.data_weights = data_weights  # (M, 1) float32, 0 on padding
        self.size = size                  # real datapoints in this batch


class MoleculeDataLoader:
    """Iterable over DeviceBatches with a stable padding envelope."""

    def __init__(self, dataset: MoleculeDataset, config: FeaturizationConfig,
                 batch_size: int = 50, shuffle: bool = False, seed: int = 0,
                 class_balance: bool = False, num_workers: int = 8,
                 align: int = 256, use_native: Optional[bool] = None):
        self.dataset = dataset
        self.config = config
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.class_balance = class_balance
        self._random = Random(seed)
        self.num_workers = num_workers
        self._align = align
        self._pad_atoms: Optional[int] = None
        self._pad_bonds: Optional[int] = None
        self._counts: Optional[List[tuple]] = None
        self.number_of_molecules = (len(dataset[0].smiles) if len(dataset)
                                    else 1)
        # None = auto = the C++ featurizer: every configuration the port
        # takes is native-eligible (the JAX loader's extra-feature
        # branches are not needed while the port rejects feature files)
        self.use_native = use_native is None or bool(use_native)
        self._native_kw = dict(
            polymer=config.polymer,
            reaction_mode=config.reaction_mode if config.reaction else None,
            keep_h=config.explicit_h, add_h=config.adding_h)

    # -- sampling (reference MoleculeSampler, data.py:537-591) --------------
    def _indices(self) -> List[int]:
        indices = list(range(len(self.dataset)))
        if self.class_balance:
            has_active = [any(t == 1 for t in self.dataset[i].targets
                              if t is not None) for i in indices]
            positives = [i for i in indices if has_active[i]]
            negatives = [i for i in indices if not has_active[i]]
            if self.shuffle:
                self._random.shuffle(positives)
                self._random.shuffle(negatives)
            return [idx for pair in zip(positives, negatives) for idx in pair]
        if self.shuffle:
            self._random.shuffle(indices)
        return indices

    def __len__(self) -> int:
        if self.class_balance:
            return math.ceil(len(self._indices()) / self.batch_size)
        return math.ceil(len(self.dataset) / self.batch_size)

    def targets(self) -> List[List[Optional[float]]]:
        if self.class_balance or self.shuffle:
            raise ValueError("Cannot safely extract targets when class_balance "
                             "or shuffle are enabled.")
        return [d.targets for d in self.dataset]

    # -- envelope -----------------------------------------------------------
    def _compute_envelope(self, order: List[int]) -> None:
        """Pad sizes covering every batch under the current order. Sticky
        (monotone non-decreasing) and aligned, so a reshuffle almost always
        keeps the shape. Per-datapoint counts are computed once."""
        if self._counts is None and self.use_native:
            from ..native_ext import count_native
            a = np.zeros(len(self.dataset), np.int64)
            b = np.zeros(len(self.dataset), np.int64)
            for pos in range(self.number_of_molecules):
                ap, bp = count_native([d.smiles[pos] for d in self.dataset],
                                      n_threads=self.num_workers,
                                      **self._native_kw)
                a += np.maximum(ap, 0)      # -1 marks an invalid SMILES
                b += np.maximum(bp, 0)
            self._counts = list(zip(a.tolist(), b.tolist()))
        elif self._counts is None:
            self._counts = []
            for d in self.dataset:
                graphs = d.mol_graphs(self.config)
                self._counts.append((sum(g.n_atoms for g in graphs),
                                     sum(g.n_bonds for g in graphs)))
        counts = self._counts
        max_a = max_b = 0
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            max_a = max(max_a, 1 + sum(counts[j][0] for j in chunk))
            max_b = max(max_b, 1 + sum(counts[j][1] for j in chunk))
        self._pad_atoms = max(self._pad_atoms or 0,
                              round_up(max(max_a, 1), self._align))
        self._pad_bonds = max(self._pad_bonds or 0,
                              round_up(max(max_b, 1), self._align))

    def _make_batch(self, idxs: List[int]) -> DeviceBatch:
        points = [self.dataset[i] for i in idxs]
        graph_arrays = []
        for pos in range(self.number_of_molecules):
            if self.use_native:
                from ..native_ext import featurize_batch_native
                gb, _ = featurize_batch_native(
                    [p.smiles[pos] for p in points],
                    pad_atoms=self._pad_atoms, pad_bonds=self._pad_bonds,
                    pad_mols=self.batch_size, n_threads=self.num_workers,
                    **self._native_kw)
            else:
                graphs = [p.mol_graphs(self.config)[pos] for p in points]
                gb = batch_graphs(graphs, pad_atoms=self._pad_atoms,
                                  pad_bonds=self._pad_bonds,
                                  pad_mols=self.batch_size)
            graph_arrays.append(gb.arrays(sorted_aux=True))
        M = self.batch_size
        num_tasks = len(points[0].targets) \
            if points[0].targets is not None else 0
        targets = np.zeros((M, num_tasks), np.float32)
        mask = np.zeros((M, num_tasks), np.float32)
        weights = np.zeros((M, 1), np.float32)
        for i, p in enumerate(points):
            if p.targets is not None:
                for t, v in enumerate(p.targets):
                    if v is not None:
                        targets[i, t] = v
                        mask[i, t] = 1.0
            weights[i, 0] = p.data_weight
        return DeviceBatch(graph_arrays, targets, mask, weights,
                           size=len(points))

    def __iter__(self) -> Iterator[DeviceBatch]:
        order = self._indices()
        if self._pad_atoms is None or self.shuffle:
            self._compute_envelope(order)
        chunks = [order[i:i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]
        if self.num_workers > 1 and len(chunks) > 1:
            with ThreadPoolExecutor(max_workers=min(self.num_workers, 8)) as ex:
                futures = [ex.submit(self._make_batch, c) for c in chunks]
                for f in futures:
                    yield f.result()
        else:
            for c in chunks:
                yield self._make_batch(c)
