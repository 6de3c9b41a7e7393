"""Kier–Hall electrotopological state (EState) indices.

Replaces ``rdkit.Chem.EState`` for the descriptor set (MaxEStateIndex /
MinEStateIndex / MaxAbsEStateIndex / MinAbsEStateIndex and the
EState_VSA / VSA_EState bins consumed by the reference's rdkit_2d
generator).  Formulas per Kier & Hall:

* intrinsic state  I = ((2/n)^2 * dv + 1) / d   with  n = principal
  quantum number, dv = Zv - nH (valence electrons minus hydrogens),
  d = heavy-atom degree
* EState index     S_i = I_i + sum_j (I_i - I_j) / (r_ij + 1)^2  with
  r_ij the topological (bond-count) distance
"""

from __future__ import annotations

from typing import List

from ..mol import Molecule
from ..periodic import outer_electrons

# principal quantum number by atomic number
def _principal_quantum_number(z: int) -> int:
    if z <= 2:
        return 1
    if z <= 10:
        return 2
    if z <= 18:
        return 3
    if z <= 36:
        return 4
    if z <= 54:
        return 5
    if z <= 86:
        return 6
    return 7


def graph_distances(mol: Molecule) -> List[List[int]]:
    """All-pairs topological distances (BFS; heavy atoms only)."""
    n = mol.n_atoms
    dist = [[-1] * n for _ in range(n)]
    for src in range(n):
        row = dist[src]
        row[src] = 0
        frontier = [src]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for a in frontier:
                for b in mol.neighbors(a):
                    if row[b] < 0:
                        row[b] = d
                        nxt.append(b)
            frontier = nxt
    return dist


def intrinsic_states(mol: Molecule) -> List[float]:
    out = []
    for a in mol.atoms:
        d = mol.degree(a.idx)
        if d == 0:
            out.append(0.0)
            continue
        zv = outer_electrons(a.atomic_num)
        dv = zv - a.num_hs
        n = _principal_quantum_number(a.atomic_num)
        out.append(((2.0 / n) ** 2 * dv + 1.0) / d)
    return out


def estate_indices(mol: Molecule) -> List[float]:
    i_states = intrinsic_states(mol)
    dist = graph_distances(mol)
    n = mol.n_atoms
    out = list(i_states)
    for i in range(n):
        acc = 0.0
        for j in range(n):
            if i == j:
                continue
            r = dist[i][j]
            if r < 0:       # disconnected fragments do not interact
                continue
            acc += (i_states[i] - i_states[j]) / float((r + 1) ** 2)
        out[i] = i_states[i] + acc
    return out
