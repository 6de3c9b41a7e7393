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
