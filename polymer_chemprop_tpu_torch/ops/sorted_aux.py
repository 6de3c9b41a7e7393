"""Host-side dst-sorted bond layout for the CUDA message-passing kernels.

The port's copy of ``build_sorted_aux`` (polymer_chemprop_tpu
ops/pallas_mpnn.py:173-298), reduced to what a kernel with no window
needs. Bonds are sorted by destination atom, so the incoming bonds of atom
``v`` form one contiguous run ``[rowptr[v], rowptr[v + 1])`` (a CSR over
the dst-sorted bonds). The TPU kernels' window starts (``rs``, ``rs_rev``,
``ra``) and their overflow fallback do not exist here: a CUDA block reads
each run through ``rowptr`` directly.

Invariants (as in the JAX package):

* slot 0 is padding; every padding bond (dst 0) is sorted LAST and belongs
  to no atom's run (``rowptr[0] == rowptr[1] == 0``), so it is read only as
  its own reverse;
* padding bonds are their own reverse, which makes ``srev`` an involution
  (a true permutation) over all ``B`` slots;
* ``f_bonds`` is permuted into dst-sorted order on the host
  (:meth:`GraphBatch.arrays`).

:func:`build_molecule_csr` is the same layout one level up: the atom rows
of each molecule as one CSR run, which the molecule readout sums in row
order (``ops/band_mpnn.py`` :func:`molecule_readout_sorted`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class SortedBondAux(NamedTuple):
    """Index arrays of one batch in dst-sorted bond order.

    perm:       (B,) natural bond id at each sorted position
    srev:       (B,) sorted position of each sorted bond's reverse (an
                involution: padding bonds are their own reverse)
    src_sorted: (B,) source atom of each sorted bond (0 for padding)
    dst_sorted: (B,) destination atom of each sorted bond (0 for padding)
    w_sorted:   (B,) bond weight of each sorted bond (0 for padding)
    rowptr:     (A + 1,) CSR offsets: the incoming bonds of atom v are the
                sorted positions [rowptr[v], rowptr[v + 1]); atom 0 (the
                padding slot) has none
    """

    perm: np.ndarray
    srev: np.ndarray
    src_sorted: np.ndarray
    dst_sorted: np.ndarray
    w_sorted: np.ndarray
    rowptr: np.ndarray


def build_sorted_aux(b2dst: np.ndarray, b2revb: np.ndarray,
                     w_bonds: np.ndarray,
                     num_atoms: Optional[int] = None) -> SortedBondAux:
    """Sort one GraphBatch's bonds by destination atom and index them."""
    B = int(b2dst.shape[0])
    dst = b2dst.astype(np.int64)
    A = int(num_atoms) if num_atoms is not None else int(dst.max()) + 1
    # padding bonds (dst 0) sort last through a sentinel key
    key = np.where(dst > 0, dst, np.int64(1) << 30)
    perm = np.argsort(key, kind="stable").astype(np.int32)
    rank = np.empty(B, np.int32)
    rank[perm] = np.arange(B, dtype=np.int32)
    # padding bonds all carry b2revb == 0; make each its own reverse so the
    # reverse map is a permutation (semantics of real bonds unchanged)
    idx = np.arange(B, dtype=np.int64)
    rev_eff = np.where((b2revb == 0) & (idx != 0), idx, b2revb)
    srev = rank[rev_eff[perm]].astype(np.int32)
    dst_sorted = b2dst[perm].astype(np.int32)
    # src(b) = dst(rev(b)); padding bonds are their own reverse -> src 0
    src_sorted = b2dst[rev_eff[perm]].astype(np.int32)
    w_sorted = w_bonds[perm].astype(np.float32)
    counts = np.bincount(dst_sorted[dst_sorted > 0], minlength=A)
    if counts.shape[0] > A:
        raise ValueError(f"bond destination {counts.shape[0] - 1} is outside "
                         f"the {A}-atom envelope")
    rowptr = np.zeros(A + 1, np.int32)
    np.cumsum(counts, out=rowptr[1:])
    return SortedBondAux(perm, srev, src_sorted, dst_sorted, w_sorted, rowptr)


def build_molecule_csr(a2mol: np.ndarray, w_atoms: np.ndarray,
                       num_mols: int,
                       rows: Optional[np.ndarray] = None) -> dict:
    """``rows`` (by default the batch's real atoms) grouped by molecule in
    row order: ``mol_idx`` (int32, one entry per
    row of ``a2mol``, so that every batch of an envelope has one shape:
    the grouped rows, then 0 on entries that lie in no run),
    ``mol_rowptr`` (``num_mols + 1`` int32 offsets: molecule m's atoms are
    ``mol_idx[mol_rowptr[m]:mol_rowptr[m + 1]]``) and ``mol_denom``, each
    molecule's float32 weight sum added in that order (the ``mean``
    aggregation's denominator).

    Atoms are packed from row 1 in molecule order, and the tail padding
    rows (molecule 0, weight 0) follow the last of them: so the real atoms
    are rows 1 up to the last row of a molecule other than 0 or of a
    weight other than 0. (A zero-weight atom of molecule 0 that ends a
    batch with no other atom is left out; it adds exactly 0 to every
    sum.)"""
    a2mol = np.asarray(a2mol)
    w = np.asarray(w_atoms, np.float32)
    if rows is None:
        last = np.nonzero((a2mol[1:] != 0) | (w[1:] != 0))[0]
        rows = np.arange(1, 2 + last[-1]) if last.size else \
            np.zeros(0, np.int64)
    rows = rows[np.argsort(a2mol[rows], kind="stable")]
    mols = a2mol[rows]
    if mols.size and int(mols.max()) >= num_mols:
        raise ValueError(f"atom of molecule {int(mols.max())} outside the "
                         f"{num_mols}-molecule envelope")
    rowptr = np.zeros(num_mols + 1, np.int32)
    np.cumsum(np.bincount(mols, minlength=num_mols), out=rowptr[1:])
    denom = np.zeros(num_mols, np.float32)
    np.add.at(denom, mols, w[rows])
    idx = np.zeros(a2mol.shape[0], np.int32)
    idx[:rows.shape[0]] = rows
    return {"mol_idx": idx, "mol_rowptr": rowptr, "mol_denom": denom}


def sorted_batch(arrays: dict) -> dict:
    """One batch's natural-order arrays (``GraphBatch.arrays()``) in the
    layout the encoder's kernel branch reads: under ``"sorted_aux"`` the
    arrays of :func:`build_sorted_aux` and :func:`build_molecule_csr`,
    and ``f_bonds`` permuted into dst-sorted order."""
    aux = build_sorted_aux(arrays["b2dst"], arrays["b2revb"],
                           arrays["w_bonds"],
                           num_atoms=arrays["f_atoms"].shape[0])
    mol = build_molecule_csr(arrays["a2mol"], arrays["w_atoms"],
                             arrays["degree_of_polym"].shape[0])
    return dict(arrays, sorted_aux=dict(aux._asdict(), **mol),
                f_bonds=arrays["f_bonds"][aux.perm])
