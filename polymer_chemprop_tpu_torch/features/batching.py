"""Static-shape graph batching.

Replaces the reference ``BatchMolGraph`` (featurization.py:742-875). The
reference concatenates ragged per-molecule arrays and pads ``a2b`` to the
batch max in-degree, a data-dependent shape. Here every batch is padded to
a fixed ``(pad_atoms, pad_bonds, pad_mols)`` envelope so the kernels see
one shape per run, and message aggregation uses flat ``b2dst``
segment ids (edge-parallel layout) instead of dense per-atom gather
matrices, so no ``max_in_degree`` dimension is ever materialized.

Index 0 of the atom and bond axes is reserved as a zero-padding slot, the
same trick as the reference (featurization.py:767-781): padded entries point
at index 0 and carry zero weight, so they contribute nothing to any segment
reduction.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .featurization import MolGraph


@dataclasses.dataclass
class GraphBatch:
    """A fixed-shape batch of molecular graphs (numpy arrays).

    Shapes: A = pad_atoms, B = pad_bonds (directed), M = pad_mols.
    Row/slot 0 of the atom and bond axes is the zero-padding slot.
    """

    f_atoms: np.ndarray        # (A, atom_fdim) float32
    f_bonds: np.ndarray        # (B, bond_fdim) float32, concat(src atom feats, bond feats)
    w_atoms: np.ndarray        # (A,) float32; stoichiometry weight, 0 on padding
    w_bonds: np.ndarray        # (B,) float32; stochastic edge weight, 0 on padding
    b2a: np.ndarray            # (B,) int32; source atom of each directed bond
    b2dst: np.ndarray          # (B,) int32; destination atom (segment ids)
    b2revb: np.ndarray         # (B,) int32; reverse directed bond
    a2mol: np.ndarray          # (A,) int32; owning molecule (0 for padding)
    degree_of_polym: np.ndarray  # (M,) float32; 1 + log10(Xn), 1.0 for non-polymer
    mol_mask: np.ndarray       # (M,) float32; 1 for real molecules
    n_atoms_real: int = 0      # actual atom count incl. slot 0
    n_bonds_real: int = 0      # actual bond count incl. slot 0

    @property
    def n_mols(self) -> int:
        return self.degree_of_polym.shape[0]

    def arrays(self, sorted_aux: bool = False) -> dict:
        """The per-batch numpy arrays the encoder consumes.

        With ``sorted_aux=True``, in the layout of
        :func:`~polymer_chemprop_tpu_torch.ops.sorted_aux.sorted_batch`:
        the dst-sorted bond index arrays and the molecule CSR under
        ``"sorted_aux"`` (the encoder then runs its kernel branch), and
        ``f_bonds`` in dst-sorted order: the host permute is free here and
        keeps a B-row gather off the device."""
        d = {k: getattr(self, k) for k in (
            "f_atoms", "f_bonds", "w_atoms", "w_bonds",
            "b2a", "b2dst", "b2revb", "a2mol", "degree_of_polym", "mol_mask")}
        if sorted_aux:
            from ..ops.sorted_aux import sorted_batch
            return sorted_batch(d)
        return d


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def batch_graphs(graphs: Sequence[MolGraph],
                 pad_atoms: Optional[int] = None,
                 pad_bonds: Optional[int] = None,
                 pad_mols: Optional[int] = None,
                 align: int = 128) -> GraphBatch:
    """Pack MolGraphs into one fixed-shape GraphBatch.

    When pad_* are omitted they are rounded up to ``align`` so repeated
    calls land on a small set of compiled shapes; training pipelines should
    pass dataset-level constants for a single compilation.
    """
    n_mols = len(graphs)
    n_atoms = 1 + sum(g.n_atoms for g in graphs)
    n_bonds = 1 + sum(g.n_bonds for g in graphs)
    A = pad_atoms if pad_atoms is not None else round_up(n_atoms, align)
    B = pad_bonds if pad_bonds is not None else round_up(n_bonds, align)
    M = pad_mols if pad_mols is not None else n_mols
    if n_atoms > A or n_bonds > B or n_mols > M:
        raise ValueError(
            f"batch exceeds padding envelope: atoms {n_atoms}>{A} or "
            f"bonds {n_bonds}>{B} or mols {n_mols}>{M}")

    atom_fdim = len(graphs[0].f_atoms[0]) if graphs and graphs[0].n_atoms else 0
    bond_fdim = len(graphs[0].f_bonds[0]) if graphs and graphs[0].n_bonds else \
        (atom_fdim + 14)

    f_atoms = np.zeros((A, atom_fdim), dtype=np.float32)
    f_bonds = np.zeros((B, bond_fdim), dtype=np.float32)
    w_atoms = np.zeros((A,), dtype=np.float32)
    w_bonds = np.zeros((B,), dtype=np.float32)
    b2a = np.zeros((B,), dtype=np.int32)
    b2dst = np.zeros((B,), dtype=np.int32)
    b2revb = np.zeros((B,), dtype=np.int32)
    a2mol = np.zeros((A,), dtype=np.int32)
    degree_of_polym = np.ones((M,), dtype=np.float32)
    mol_mask = np.zeros((M,), dtype=np.float32)

    ai, bi = 1, 1  # slot 0 reserved for padding
    for mi, g in enumerate(graphs):
        na, nb = g.n_atoms, g.n_bonds
        if na:
            f_atoms[ai:ai + na] = np.asarray(g.f_atoms, dtype=np.float32)
            w_atoms[ai:ai + na] = np.asarray(g.w_atoms, dtype=np.float32)
            a2mol[ai:ai + na] = mi
        if nb:
            f_bonds[bi:bi + nb] = np.asarray(g.f_bonds, dtype=np.float32)
            w_bonds[bi:bi + nb] = np.asarray(g.w_bonds, dtype=np.float32)
            b2a[bi:bi + nb] = np.asarray(g.b2a, dtype=np.int32) + ai
            b2dst[bi:bi + nb] = np.asarray(g.b2dst, dtype=np.int32) + ai
            b2revb[bi:bi + nb] = np.asarray(g.b2revb, dtype=np.int32) + bi
        degree_of_polym[mi] = g.degree_of_polym
        mol_mask[mi] = 1.0
        ai += na
        bi += nb

    return GraphBatch(
        f_atoms=f_atoms, f_bonds=f_bonds, w_atoms=w_atoms, w_bonds=w_bonds,
        b2a=b2a, b2dst=b2dst, b2revb=b2revb, a2mol=a2mol,
        degree_of_polym=degree_of_polym, mol_mask=mol_mask,
        n_atoms_real=ai, n_bonds_real=bi)


def mol2graph(mols: Sequence, config=None, atom_features_batch=None,
              bond_features_batch=None, **pad_kw) -> GraphBatch:
    """SMILES/Molecule list -> GraphBatch (reference mol2graph,
    featurization.py:878-898)."""
    from .config import FeaturizationConfig
    config = config or FeaturizationConfig()
    from itertools import zip_longest
    afb = atom_features_batch if atom_features_batch is not None else (None,)
    bfb = bond_features_batch if bond_features_batch is not None else (None,)
    graphs = [MolGraph(m, config, af, bf)
              for m, af, bf in zip_longest(mols, afb, bfb)]
    return batch_graphs(graphs, **pad_kw)
