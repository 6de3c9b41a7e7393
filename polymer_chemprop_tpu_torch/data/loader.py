"""Batch loader: dataset -> fixed-shape host arrays.

The port's copy of polymer_chemprop_tpu data/loader.py without the Pallas
switches. By default each batch is featurized and packed by the C++
library of native_ext.py (standard, polymer and reaction configurations,
with explicit or added hydrogens), which is bit for bit the pure-Python
path (``features/``); ``use_native=False`` takes the Python path. Extra
per-atom and per-bond features stay on the C++ path only for standard
single-molecule configurations, widened by :meth:`MoleculeDataLoader.
_apply_extras`; polymers, reactions and multi-molecule rows with extras
take the Python path, as in the JAX package. Molecule-level features ride
along as ``(M, F)`` and atom descriptors as ``(pad_atoms, D)`` (row 0 is
padding), both float32. Batches are made on a thread pool when
there is more than one (a ctypes call releases the GIL), and every batch
carries the dst-sorted bond layout of ops/sorted_aux.py (``sorted_aux=False``
keeps the natural bond pair order, for the edge partitioner). Every emitted
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
                 data_weights: np.ndarray, size: int,
                 features: Optional[np.ndarray] = None,
                 atom_descriptors: Optional[np.ndarray] = None):
        self.graph_arrays = graph_arrays  # one dict per molecule position
        self.targets = targets            # (M, T) float32, 0 where missing
        self.mask = mask                  # (M, T) float32, 1 where present
        self.data_weights = data_weights  # (M, 1) float32, 0 on padding
        self.size = size                  # real datapoints in this batch
        self.features = features          # (M, F) float32 or None
        # (pad_atoms, D) float32 or None, aligned with the atom axis
        self.atom_descriptors = atom_descriptors

    def masked_out(self) -> "DeviceBatch":
        """This batch with mask and loss weights zero: it pads a
        data-parallel group and contributes nothing to the loss."""
        return DeviceBatch(self.graph_arrays, self.targets,
                           np.zeros_like(self.mask),
                           np.zeros_like(self.data_weights), self.size,
                           self.features, self.atom_descriptors)

    def sorted_layout(self) -> "DeviceBatch":
        """This natural-order batch with every molecule position in the
        dst-sorted layout (ops/sorted_aux.py ``sorted_batch``), as a loader
        with ``sorted_aux=True`` builds it: the encoder then runs its
        kernel branch, whose sums run in a fixed order."""
        from ..ops.sorted_aux import sorted_batch
        return DeviceBatch([sorted_batch(g) for g in self.graph_arrays],
                           self.targets, self.mask, self.data_weights,
                           self.size, self.features, self.atom_descriptors)


class MoleculeDataLoader:
    """Iterable over DeviceBatches with a stable padding envelope."""

    def __init__(self, dataset: MoleculeDataset, config: FeaturizationConfig,
                 batch_size: int = 50, shuffle: bool = False, seed: int = 0,
                 class_balance: bool = False, num_workers: int = 8,
                 align: int = 256, use_native: Optional[bool] = None,
                 sorted_aux: bool = True):
        self.dataset = dataset
        # False: the natural (fwd, rev) bond pair order and no dst-sorted
        # layout, which the edge partitioner needs (JAX trainer.py:353-357)
        self.sorted_aux = sorted_aux
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
        # None = auto = the C++ featurizer. Extra per-atom/per-bond
        # features stay on it only for standard single-molecule
        # configurations (JAX loader.py:74-137); elsewhere they take the
        # Python path
        atom_extras = len(dataset) > 0 and dataset[0].atom_features is not None
        bond_extras = len(dataset) > 0 and dataset[0].bond_features is not None
        standard = (not config.reaction and not config.polymer
                    and self.number_of_molecules == 1)
        self.use_native = (use_native is None or bool(use_native)) and (
            standard or not (atom_extras or bond_extras))
        self._native_atom_extras = self.use_native and atom_extras
        self._native_bond_extras = self.use_native and bond_extras
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
    def estimated_pad_bonds(self) -> int:
        """Bond envelope under the identity order (the sticky envelope only
        grows from here): the trainer's graph-parallel auto rule (JAX
        loader.py:196-202)."""
        self._compute_envelope(list(range(len(self.dataset))))
        return int(self._pad_bonds)

    def estimated_pad_atoms(self) -> int:
        """The current atom envelope (computed first if needed): the
        trainer's fixed halo atom window (JAX loader.py:204-210)."""
        if self._pad_atoms is None:
            self._compute_envelope(list(range(len(self.dataset))))
        return int(self._pad_atoms)

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

    def _apply_extras(self, gb, points, valid, b2parse=None):
        """Widen a native GraphBatch with per-atom and/or per-bond extra
        features exactly like MolGraph._build_standard (extend or
        overwrite): atom extras land on the packed atom slots, bond extras
        are gathered through the native parse-order index (aligned to the
        parser's bond.idx, like the reference's bond.GetIdx()), and every
        f_bonds row re-copies its SOURCE atom's widened vector through b2a
        (padding rows stay zero because slot/index 0 is zero). The JAX
        package's loader.py:244-300."""
        if not valid.all():
            raise ValueError("invalid SMILES in a batch with extra "
                             "features (row alignment would be lost)")
        base = gb.f_atoms
        base_bond_cols = gb.f_bonds.shape[1] - base.shape[1]
        f_atoms = base
        if self._native_atom_extras:
            extras = [np.asarray(p.atom_features, np.float32)
                      for p in points]
            E = extras[0].shape[1]
            overwrite = self.config.overwrite_default_atom_features
            width = E if overwrite else base.shape[1] + E
            f_atoms = np.zeros((base.shape[0], width), np.float32)
            if not overwrite:
                f_atoms[:, :base.shape[1]] = base
            # per-molecule length check (featurization.py _build_standard)
            per_mol = np.bincount(gb.a2mol[1:gb.n_atoms_real],
                                  minlength=len(points))
            if any(per_mol[i] != ex.shape[0]
                   for i, ex in enumerate(extras)):
                raise ValueError(
                    "number of atoms differs from extra atom features")
            stacked = np.concatenate(extras, axis=0)
            f_atoms[1:1 + stacked.shape[0], width - E:] = stacked
        bond_cols = gb.f_bonds[:, -base_bond_cols:]
        if self._native_bond_extras:
            bextras = [np.asarray(p.bond_features, np.float32)
                       for p in points]
            mol_of_bond = gb.a2mol[gb.b2dst[1:gb.n_bonds_real]]
            per_mol_dir = np.bincount(mol_of_bond, minlength=len(points))
            if any(per_mol_dir[i] != 2 * bx.shape[0]
                   for i, bx in enumerate(bextras)):
                raise ValueError(
                    "number of bonds differs from extra bond features")
            Eb = bextras[0].shape[1]
            # index 0 of the zero-prepended concat catches padding rows
            cat = np.concatenate(
                [np.zeros((1, Eb), np.float32)] + bextras, axis=0)
            extra_rows = cat[b2parse]
            if self.config.overwrite_default_bond_features:
                bond_cols = extra_rows
            else:
                bond_cols = np.concatenate([bond_cols, extra_rows], axis=1)
        gb.f_atoms = f_atoms
        gb.f_bonds = np.concatenate([f_atoms[gb.b2a], bond_cols], axis=1)
        return gb

    def _make_batch(self, idxs: List[int]) -> DeviceBatch:
        points = [self.dataset[i] for i in idxs]
        extras = self._native_atom_extras or self._native_bond_extras
        graph_arrays = []
        for pos in range(self.number_of_molecules):
            if self.use_native:
                from ..native_ext import featurize_batch_native
                b2parse = (np.zeros(self._pad_bonds, np.int32)
                           if self._native_bond_extras else None)
                gb, valid = featurize_batch_native(
                    [p.smiles[pos] for p in points],
                    pad_atoms=self._pad_atoms, pad_bonds=self._pad_bonds,
                    pad_mols=self.batch_size, n_threads=self.num_workers,
                    bond_parse_out=b2parse, **self._native_kw)
                if extras:
                    gb = self._apply_extras(gb, points, valid, b2parse)
            else:
                graphs = [p.mol_graphs(self.config)[pos] for p in points]
                gb = batch_graphs(graphs, pad_atoms=self._pad_atoms,
                                  pad_bonds=self._pad_bonds,
                                  pad_mols=self.batch_size)
            graph_arrays.append(gb.arrays(sorted_aux=self.sorted_aux))
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
        feats = None
        if points[0].features is not None:
            feats = np.zeros((M, len(points[0].features)), np.float32)
            for i, p in enumerate(points):
                feats[i] = p.features
        atom_desc = None
        if points[0].atom_descriptors is not None:
            # per-atom descriptors stacked along the batched atom axis
            # (slot 0 is padding, as in the graph arrays)
            atom_desc = np.zeros((self._pad_atoms,
                                  points[0].atom_descriptors.shape[1]),
                                 np.float32)
            ai = 1
            for p in points:
                d = p.atom_descriptors
                atom_desc[ai:ai + d.shape[0]] = d
                ai += d.shape[0]
        return DeviceBatch(graph_arrays, targets, mask, weights,
                           size=len(points), features=feats,
                           atom_descriptors=atom_desc)

    def __iter__(self) -> Iterator[DeviceBatch]:
        # a generator: the order is drawn at the first batch, as before
        yield from self._batches(self._chunks())

    def iter_rank(self, rank: int, n_ranks: int) -> Iterator[DeviceBatch]:
        """Rank ``rank``'s batch of every group of ``n_ranks`` consecutive
        batches (data-parallel training; every rank draws the same order).
        In a last group shorter than ``n_ranks`` a rank past its end gets a
        masked-out copy of the group's last batch, which adds nothing to
        the loss or its gradient (JAX trainer.py:600-607, 823-832)."""
        chunks = self._chunks()
        mine, pad = [], []
        for g in range(0, len(chunks), n_ranks):
            group = chunks[g:g + n_ranks]
            pad.append(rank >= len(group))
            mine.append(group[min(rank, len(group) - 1)])
        for batch, masked in zip(self._batches(mine), pad):
            yield batch.masked_out() if masked else batch

    def _chunks(self) -> List[List[int]]:
        order = self._indices()
        if self._pad_atoms is None or self.shuffle:
            self._compute_envelope(order)
        return [order[i:i + self.batch_size]
                for i in range(0, len(order), self.batch_size)]

    def _batches(self, chunks) -> Iterator[DeviceBatch]:
        if self.num_workers > 1 and len(chunks) > 1:
            with ThreadPoolExecutor(max_workers=min(self.num_workers, 8)) as ex:
                futures = [ex.submit(self._make_batch, c) for c in chunks]
                for f in futures:
                    yield f.result()
        else:
            for c in chunks:
                yield self._make_batch(c)
