"""CIP-based stereochemistry perception.

RDKit's ``MolFromSmiles`` runs AssignStereochemistry(cleanIt=True): double
-bond E/Z labels are assigned using Cahn–Ingold–Prelog substituent
priorities, and tetrahedral chiral tags on atoms that are NOT actually
stereocenters are cleared. This module supplies both on the standalone
molecule model.

CIP comparison uses the hierarchical-digraph convention: branches are
explored breadth-first from the root substituent, double/triple bonds add
phantom duplicate atoms, and levels are compared lexicographically by
descending atomic number. This covers the overwhelmingly common cases;
exotic ties (isotopes, like-vs-unlike descriptors) fall back to "equal".
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .mol import (
    AROMATIC,
    DOUBLE,
    Molecule,
    STEREOE,
    STEREONONE,
    STEREOZ,
    TRIPLE,
)

_MAX_DEPTH = 12


def _branch_levels(mol: Molecule, root: int, first: int, depth: int):
    """BFS levels of a substituent branch: start atom ``first`` reached from
    ``root``. Each level is a sorted (descending) tuple of atomic numbers,
    with phantom duplicates for multiple bonds (CIP digraph convention)."""
    levels = []
    frontier = [(first, root)]
    level0 = [mol.atoms[first].atomic_num]
    b0 = mol.bond_between(root, first)
    if b0 is not None:
        extra = 0
        if b0.order == DOUBLE:
            extra = 1
        elif b0.order == TRIPLE:
            extra = 2
        elif b0.order == AROMATIC or b0.is_aromatic:
            extra = 0  # aromatic handled via kekule on ring traversal
        level0.extend([mol.atoms[first].atomic_num] * 0)
    levels.append(tuple(sorted(level0, reverse=True)))
    visited = {root, first}
    for _ in range(depth):
        nxt = []
        level: List[int] = []
        for a, parent in frontier:
            for b in mol.atom_bonds(a):
                o = b.other(a)
                # phantom duplicates for multiple bonds (count both ways)
                mult = 0
                if b.order == DOUBLE:
                    mult = 1
                elif b.order == TRIPLE:
                    mult = 2
                elif (b.order == AROMATIC or b.is_aromatic) \
                        and b.kekule_order == DOUBLE:
                    mult = 1
                if o == parent:
                    level.extend([mol.atoms[parent].atomic_num] * mult)
                    continue
                level.append(mol.atoms[o].atomic_num)
                level.extend([mol.atoms[o].atomic_num] * mult)
                if o not in visited:
                    visited.add(o)
                    nxt.append((o, a))
        # implicit hydrogens of the frontier
        for a, parent in frontier:
            level.extend([1] * mol.atoms[a].num_hs)
        if not level:
            break
        levels.append(tuple(sorted(level, reverse=True)))
        frontier = nxt
        if not frontier:
            break
    return levels


def compare_branches(mol: Molecule, root: int, a: int, b: int) -> int:
    """CIP comparison of two substituent branches from ``root``:
    returns >0 if branch a has priority, <0 if b, 0 if indistinguishable."""
    if a == b:
        return 0
    la = _branch_levels(mol, root, a, _MAX_DEPTH)
    lb = _branch_levels(mol, root, b, _MAX_DEPTH)
    for i in range(max(len(la), len(lb))):
        va = la[i] if i < len(la) else ()
        vb = lb[i] if i < len(lb) else ()
        if va != vb:
            return 1 if va > vb else -1
    return 0


def _high_priority_neighbor(mol: Molecule, atom: int, exclude: int
                            ) -> Tuple[Optional[int], bool]:
    """Highest-CIP-priority neighbour of ``atom`` (excluding ``exclude``).
    Returns (neighbour or None, tie_flag)."""
    nbrs = [n for n in mol.neighbors(atom) if n != exclude]
    if not nbrs:
        return None, False
    if len(nbrs) == 1:
        # implicit H competes but always loses to any heavy atom
        return nbrs[0], False
    c = compare_branches(mol, atom, nbrs[0], nbrs[1])
    if c == 0:
        return None, True  # symmetric substituents: no stereo possible
    return (nbrs[0] if c > 0 else nbrs[1]), False


def assign_double_bond_stereo(mol: Molecule) -> None:
    """E/Z from direction markers + CIP priorities (replaces the marker-only
    heuristic): STEREOZ iff the two HIGH-PRIORITY substituents are cis."""
    for b in mol.bonds:
        b.stereo = STEREONONE
        if b.order != DOUBLE or b.in_ring:
            continue
        ref1 = mol._directional_neighbor(b.a1, b.idx)
        ref2 = mol._directional_neighbor(b.a2, b.idx)
        if ref1 is None or ref2 is None:
            continue
        (n1, d1), (n2, d2) = ref1, ref2
        marked1 = mol.bonds[n1].other(b.a1)
        marked2 = mol.bonds[n2].other(b.a2)
        # side of the marked neighbours (see mol._assign_bond_stereo)
        s1 = d1 if mol.bonds[n1].a1 == b.a1 else -d1
        s2 = d2 if mol.bonds[n2].a1 == b.a2 else -d2
        hi1, tie1 = _high_priority_neighbor(mol, b.a1, b.a2)
        hi2, tie2 = _high_priority_neighbor(mol, b.a2, b.a1)
        if tie1 or tie2:
            continue  # not stereogenic
        if hi1 is None or hi2 is None:
            hi1 = hi1 if hi1 is not None else marked1
            hi2 = hi2 if hi2 is not None else marked2
        # flip the marked side to the high-priority substituent's side
        if hi1 != marked1:
            s1 = -s1
        if hi2 != marked2:
            s2 = -s2
        b.stereo = STEREOZ if s1 == s2 else STEREOE


def clear_nonstereogenic_chiral_tags(mol: Molecule) -> None:
    """RDKit cleanIt=True behaviour: drop @/@@ tags on atoms whose
    substituents are not pairwise CIP-distinguishable."""
    for atom in mol.atoms:
        if atom.chiral_tag == 0:
            continue
        nbrs = mol.neighbors(atom.idx)
        n_branches = len(nbrs) + atom.num_hs
        if n_branches < 4 and not (len(nbrs) == 3 and atom.num_hs == 0):
            atom.chiral_tag = 0
            continue
        if atom.num_hs > 1:
            atom.chiral_tag = 0
            continue
        distinguishable = True
        for i in range(len(nbrs)):
            for j in range(i + 1, len(nbrs)):
                if compare_branches(mol, atom.idx, nbrs[i], nbrs[j]) == 0:
                    distinguishable = False
                    break
            if not distinguishable:
                break
        if not distinguishable:
            atom.chiral_tag = 0


def assign_stereochemistry(mol: Molecule) -> None:
    assign_double_bond_stereo(mol)
    clear_nonstereogenic_chiral_tags(mol)
