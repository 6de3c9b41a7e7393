"""Batch loader: dataset -> fixed-shape host arrays for prediction.

The port's copy of polymer_chemprop_tpu data/loader.py, cut to what
prediction needs: in-order batches, no native featurizer and no Pallas
switches. Featurization is the pure-Python path (which the JAX package
holds bit-identical to its C++ one), on a thread pool when there is more
than one batch, and every batch carries the dst-sorted bond layout of
ops/sorted_aux.py. Every emitted batch shares one padding envelope
(loader.py:211-248), so the kernels see one shape per run.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..features import FeaturizationConfig, batch_graphs, round_up
from .datapoint import MoleculeDataset


class DeviceBatch:
    """Host-side arrays of one batch."""

    def __init__(self, graph_arrays: List[Dict[str, np.ndarray]], size: int):
        self.graph_arrays = graph_arrays  # one dict per molecule position
        self.size = size                  # real datapoints in this batch


class MoleculeDataLoader:
    """Iterable over DeviceBatches with a stable padding envelope."""

    def __init__(self, dataset: MoleculeDataset, config: FeaturizationConfig,
                 batch_size: int = 50, num_workers: int = 8,
                 align: int = 256):
        self.dataset = dataset
        self.config = config
        self.batch_size = batch_size
        self.num_workers = num_workers
        self._align = align
        self._pad_atoms: Optional[int] = None
        self._pad_bonds: Optional[int] = None
        self.number_of_molecules = (len(dataset[0].smiles) if len(dataset)
                                    else 1)

    def __len__(self) -> int:
        return math.ceil(len(self.dataset) / self.batch_size)

    def _compute_envelope(self) -> None:
        """Pad sizes covering every batch, computed once per loader, so
        every batch of a run (and every ensemble member) has one shape."""
        counts = []
        for d in self.dataset:
            graphs = d.mol_graphs(self.config)
            counts.append((sum(g.n_atoms for g in graphs),
                           sum(g.n_bonds for g in graphs)))
        max_a = max_b = 0
        for i in range(0, len(counts), self.batch_size):
            chunk = counts[i:i + self.batch_size]
            max_a = max(max_a, 1 + sum(a for a, _ in chunk))
            max_b = max(max_b, 1 + sum(b for _, b in chunk))
        self._pad_atoms = round_up(max_a, self._align)
        self._pad_bonds = round_up(max_b, self._align)

    def _make_batch(self, idxs: List[int]) -> DeviceBatch:
        points = [self.dataset[i] for i in idxs]
        graph_arrays = []
        for pos in range(self.number_of_molecules):
            graphs = [p.mol_graphs(self.config)[pos] for p in points]
            gb = batch_graphs(graphs, pad_atoms=self._pad_atoms,
                              pad_bonds=self._pad_bonds,
                              pad_mols=self.batch_size)
            graph_arrays.append(gb.arrays(sorted_aux=True))
        return DeviceBatch(graph_arrays, size=len(points))

    def __iter__(self) -> Iterator[DeviceBatch]:
        if self._pad_atoms is None:
            self._compute_envelope()
        order = list(range(len(self.dataset)))
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
