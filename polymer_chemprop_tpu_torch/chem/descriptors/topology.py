"""Topological indices: Chi connectivity, Kappa shape, HallKierAlpha,
BalabanJ, BertzCT, Ipc.

Standalone replacement for ``rdkit.Chem.GraphDescriptors`` for the
reference rdkit_2d columns.  Formulas follow Kier & Hall / Balaban /
Bertz as implemented by RDKit (simple-path enumeration with distinct
atoms, valence deltas with the (Z - Zv - 1) scaling for Z > 10,
bond-order-weighted distance matrix for BalabanJ).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from ..mol import AROMATIC, Molecule
from ..periodic import outer_electrons
from .estate import _principal_quantum_number
from .hybrid import conjugated_lone_pair_sp2


def _simple_deltas(mol: Molecule) -> List[int]:
    return [mol.degree(i) for i in range(mol.n_atoms)]


def _valence_deltas(mol: Molecule) -> List[float]:
    """Hall-Kier delta-v: (Zv - h) for second row, scaled for heavier."""
    out = []
    for a in mol.atoms:
        z = a.atomic_num
        zv = outer_electrons(z)
        dv = zv - a.num_hs
        if z > 10:
            dv = float(dv) / (z - zv - 1)
        out.append(float(dv))
    return out


def _n_deltas(mol: Molecule) -> List[float]:
    """RDKit _nVal used by the ChiNn series: Zv - h (unscaled)."""
    return [float(outer_electrons(a.atomic_num) - a.num_hs)
            for a in mol.atoms]


def _paths_of_length(mol: Molecule, n_bonds: int) -> List[List[int]]:
    """Paths with ``n_bonds`` DISTINCT BONDS (atoms may repeat — closed
    ring walks count, RDKit FindAllPathsOfLengthN semantics), undirected;
    each path counted once."""
    seen = set()
    paths = []

    def extend(path, bonds):
        if len(bonds) == n_bonds:
            key = frozenset(bonds)
            if key not in seen:
                seen.add(key)
                paths.append(list(path))
            return
        for b in mol.atom_bonds(path[-1]):
            if b.idx in bonds:
                continue
            nb = b.other(path[-1])
            # disallow revisiting atoms mid-path, but allow closing back
            # onto an earlier atom at the last step (ring walks)
            if nb in path and not (len(bonds) == n_bonds - 1):
                continue
            path.append(nb)
            bonds.append(b.idx)
            extend(path, bonds)
            bonds.pop()
            path.pop()

    for a in range(mol.n_atoms):
        extend([a], [])
    return paths


def _chi_from_deltas(mol: Molecule, deltas, order: int) -> float:
    if order == 0:
        return sum(1.0 / math.sqrt(d) for d in deltas if d > 0)
    if order == 1:
        acc = 0.0
        for b in mol.bonds:
            d1, d2 = deltas[b.a1], deltas[b.a2]
            if d1 > 0 and d2 > 0:
                acc += 1.0 / math.sqrt(d1 * d2)
        return acc
    acc = 0.0
    for path in _paths_of_length(mol, order):
        prod = 1.0
        ok = True
        # ring walks: each atom counted once; SORTED so the product's
        # rounding order is portable (the native port multiplies in the
        # same order — tests/test_native.py bit-equality)
        for a in sorted(set(path)):
            if deltas[a] <= 0:
                ok = False
                break
            prod *= deltas[a]
        if ok:
            acc += 1.0 / math.sqrt(prod)
    return acc


def chi0(mol):
    return _chi_from_deltas(mol, _simple_deltas(mol), 0)


def chi1(mol):
    return _chi_from_deltas(mol, _simple_deltas(mol), 1)


def chi_nv(mol: Molecule, order: int) -> float:
    return _chi_from_deltas(mol, _valence_deltas(mol), order)


def chi_nn(mol: Molecule, order: int) -> float:
    return _chi_from_deltas(mol, _n_deltas(mol), order)


# ---------------------------------------------------------------------------
# Hall-Kier alpha and Kappa shape indices
# ---------------------------------------------------------------------------

# covalent-radius ratios per (element, hybridization): rdkit hallKierAlphas
_ALPHAS = {
    ("C", "SP"): -0.22, ("C", "SP2"): -0.13, ("C", "SP3"): 0.0,
    ("N", "SP"): -0.29, ("N", "SP2"): -0.20, ("N", "SP3"): -0.04,
    ("O", "SP2"): -0.20, ("O", "SP3"): -0.04,
    ("F", "SP3"): -0.07,
    ("P", "SP3"): 0.43,
    ("S", "SP2"): 0.22, ("S", "SP3"): 0.35,
    ("Cl", "SP3"): 0.29,
    ("Br", "SP3"): 0.48,
    ("I", "SP3"): 0.73,
}
_SYM = {6: "C", 7: "N", 8: "O", 9: "F", 15: "P", 16: "S", 17: "Cl",
        35: "Br", 53: "I"}


def hall_kier_alpha(mol: Molecule) -> float:
    acc = 0.0
    for a in mol.atoms:
        sym = _SYM.get(a.atomic_num)
        if sym is None:
            continue
        hyb = "SP2" if a.is_aromatic else a.hybridization
        # conjugating N/O lone pairs are SP2 in RDKit's model (r4:
        # HallKierAlpha 0.989->0.997, Kappa1 exact, Kappa2 0.9999)
        if hyb == "SP3" and conjugated_lone_pair_sp2(mol, a.idx):
            hyb = "SP2"
        v = _ALPHAS.get((sym, hyb))
        if v is None:
            v = _ALPHAS.get((sym, "SP3"), 0.0)
        acc += v
    return acc


def kappa1(mol: Molecule) -> float:
    alpha = hall_kier_alpha(mol)
    a = mol.n_atoms + alpha
    p1 = mol.n_bonds + alpha
    if p1 <= 0:
        return 0.0
    return a * (a - 1.0) ** 2 / (p1 * p1)


def kappa2(mol: Molecule) -> float:
    alpha = hall_kier_alpha(mol)
    a = mol.n_atoms + alpha
    p2 = len(_paths_of_length(mol, 2)) + alpha
    if p2 <= 0:
        return 0.0
    return (a - 1.0) * (a - 2.0) ** 2 / (p2 * p2)


def kappa3(mol: Molecule) -> float:
    alpha = hall_kier_alpha(mol)
    a = mol.n_atoms + alpha
    p3 = len(_paths_of_length(mol, 3)) + alpha
    if p3 == 0:
        return 0.0
    n = mol.n_atoms
    if n % 2:
        return (a - 1.0) * (a - 3.0) ** 2 / (p3 * p3)
    return (a - 3.0) * (a - 2.0) ** 2 / (p3 * p3)


# ---------------------------------------------------------------------------
# BalabanJ
# ---------------------------------------------------------------------------

def _weighted_distances(mol: Molecule) -> np.ndarray:
    """All-pairs shortest paths with edge weight 1/bond-order (aromatic
    1/1.5) — RDKit GetDistanceMatrix(useBO=1)."""
    n = mol.n_atoms
    inf = float("inf")
    d = np.full((n, n), inf)
    np.fill_diagonal(d, 0.0)
    for b in mol.bonds:
        if b.is_aromatic or b.order == AROMATIC:
            w = 1.0 / 1.5
        else:
            w = 1.0 / b.order
        d[b.a1, b.a2] = d[b.a2, b.a1] = w
    for k in range(n):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    return d


def balaban_j(mol: Molecule) -> float:
    n = mol.n_atoms
    if n < 2 or mol.n_bonds == 0:
        return 0.0
    d = _weighted_distances(mol)
    # explicit left-to-right accumulation (numpy's pairwise summation is
    # not portable to the native port's serial loop)
    s = [0.0] * n
    for i in range(n):
        acc = 0.0
        di = d[i]
        for j in range(n):
            v = di[j]
            if v != float("inf"):
                acc += v
        s[i] = acc
    q = mol.n_bonds
    # cyclomatic number; count components so disconnected inputs (salts,
    # multi-fragment SMILES) do not make mu+1 vanish
    seen = [False] * n
    ncomp = 0
    for s0 in range(n):
        if seen[s0]:
            continue
        ncomp += 1
        stack = [s0]
        seen[s0] = True
        while stack:
            u = stack.pop()
            for v in mol.neighbors(u):
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
    mu = q - n + ncomp
    acc = 0.0
    for b in mol.bonds:
        si, sj = s[b.a1], s[b.a2]
        if si > 0 and sj > 0:
            acc += 1.0 / math.sqrt(si * sj)
    return q / (mu + 1.0) * acc


# ---------------------------------------------------------------------------
# BertzCT
# ---------------------------------------------------------------------------

def _canonical_ranks(mol: Molecule) -> List[int]:
    """Symmetry classes by iterative invariant refinement (Morgan-like),
    seeded with (element, degree, charge, nH) — the equivalence classes
    RDKit's CanonicalRankAtoms(breakTies=False) produces for BertzCT."""
    n = mol.n_atoms
    inv = [hash((a.atomic_num, mol.degree(a.idx), a.formal_charge,
                 a.num_hs, a.is_aromatic)) for a in mol.atoms]
    for _ in range(n):
        ranks = {v: r for r, v in enumerate(sorted(set(inv)))}
        cur = [ranks[v] for v in inv]
        nxt = []
        for i in range(n):
            nbr = sorted(cur[j] for j in mol.neighbors(i))
            nxt.append(hash((cur[i], tuple(nbr))))
        if len(set(nxt)) == len(set(cur)):
            inv = nxt
            break
        inv = nxt
    ranks = {v: r for r, v in enumerate(sorted(set(inv)))}
    return [ranks[v] for v in inv]


def _entropy_terms(counts) -> float:
    tot = float(sum(counts))
    if tot <= 0:
        return 0.0
    ent = 0.0
    for c in counts:
        if c > 0:
            p = c / tot
            ent -= p * math.log2(p)
    return tot * ent + tot * math.log2(tot)


def bertz_ct(mol: Molecule) -> float:
    """Bertz complexity: connection-pair entropy + element entropy.

    Connections are pairs of incident bonds at each atom, classified by
    the symmetry classes of their far atoms and weighted by the product
    of the bond orders (a multiple bond acts as parallel edges, which
    also pair among themselves); the element distribution covers heavy
    atoms only. This formulation reaches rank correlation 0.9988 vs the
    vendored reference outputs (tests/test_descriptors.py)."""
    n = mol.n_atoms
    if n == 0:
        return 0.0
    ranks = _canonical_ranks(mol)
    conn = {}

    def add(key, c=1.0):
        conn[key] = conn.get(key, 0.0) + c

    for i in range(n):
        incid = []
        for b in mol.atom_bonds(i):
            if b.is_aromatic or b.order == AROMATIC:
                o = 1.5
            else:
                o = float(b.order)
            incid.append((b.other(i), o))
        for a in range(len(incid)):
            for c in range(a + 1, len(incid)):
                key = tuple(sorted((ranks[incid[a][0]],
                                    ranks[incid[c][0]])))
                add(key, incid[a][1] * incid[c][1])
        for (j, o) in incid:
            if o > 1:   # parallel edges of a multiple bond pair up too
                add(tuple(sorted((ranks[i], ranks[j]))), o * (o - 1) / 2)
    connection_ie = _entropy_terms(list(conn.values()))
    elems = {}
    for a in mol.atoms:
        elems[a.atomic_num] = elems.get(a.atomic_num, 0) + 1
    atom_ie = _entropy_terms(list(elems.values()))
    return connection_ie + atom_ie


# ---------------------------------------------------------------------------
# Ipc
# ---------------------------------------------------------------------------

def ipc(mol: Molecule, avg: bool = False) -> float:
    """Information content of the characteristic polynomial coefficients
    of the adjacency matrix (Bonchev & Trinajstic)."""
    n = mol.n_atoms
    if n == 0:
        return 0.0
    adj = np.zeros((n, n))
    for b in mol.bonds:
        adj[b.a1, b.a2] = adj[b.a2, b.a1] = 1.0
    with np.errstate(all="ignore"):
        coeffs = np.abs(np.poly(adj))
    tot = float(coeffs.sum())
    if not np.isfinite(tot):
        # large graphs overflow the characteristic polynomial — RDKit
        # returns the overflowed float; any huge sentinel lands in the
        # same saturated region of the normalization CDF
        return 1e300 if not avg else 0.0
    if tot <= 0:
        return 0.0
    p = coeffs[coeffs > 0] / tot
    p = p[p > 0]          # huge totals can underflow tiny coeffs to 0
    entropy = float(-(p * np.log2(p)).sum())
    if avg:
        return entropy
    return entropy * tot
