"""Count descriptors, masses, and TPSA.

Covers the reference rdkit_2d columns backed by ``rdkit.Chem.Descriptors``
/ ``Lipinski`` / ``rdMolDescriptors`` count functions: MolWt,
HeavyAtomMolWt, ExactMolWt, NumValenceElectrons, FractionCSP3, the ring
class counts, NHOH/NO counts, H-donor/acceptor counts, rotatable bonds
and Ertl TPSA.
"""

from __future__ import annotations

from typing import List

from ..mol import AROMATIC, Molecule
from ..periodic import atomic_mass, outer_electrons
from ..smarts import match_all

# monoisotopic masses for ExactMolWt (most-abundant isotope)
_MONOISOTOPIC = {
    1: 1.00782503207, 2: 4.002602, 3: 7.01600455, 4: 9.0121822,
    5: 11.0093054, 6: 12.0, 7: 14.0030740048, 8: 15.9949146196,
    9: 18.99840322, 11: 22.9897692809, 12: 23.9850417, 13: 26.98153863,
    14: 27.9769265325, 15: 30.97376163, 16: 31.972071, 17: 34.96885268,
    19: 38.96370668, 20: 39.96259098, 24: 51.9405075, 25: 54.9380451,
    26: 55.9349375, 29: 62.9295975, 30: 63.9291422, 33: 74.9215965,
    34: 79.9165213, 35: 78.9183371, 50: 119.9021947, 53: 126.904473,
}


def _monoiso(z: int) -> float:
    return _MONOISOTOPIC.get(z, atomic_mass(z))


def mol_wt(mol: Molecule) -> float:
    h = atomic_mass(1)
    return sum(a.mass for a in mol.atoms) + h * sum(a.num_hs
                                                    for a in mol.atoms)


def heavy_atom_mol_wt(mol: Molecule) -> float:
    return sum(a.mass for a in mol.atoms if a.atomic_num != 1)


def exact_mol_wt(mol: Molecule) -> float:
    acc = 0.0
    for a in mol.atoms:
        acc += (atomic_mass(a.atomic_num, a.isotope) if a.isotope
                else _monoiso(a.atomic_num))
        acc += a.num_hs * _MONOISOTOPIC[1]
    return acc


def num_valence_electrons(mol: Molecule) -> int:
    tot = 0
    for a in mol.atoms:
        tot += outer_electrons(a.atomic_num) - a.formal_charge + a.num_hs
    return tot


def fraction_csp3(mol: Molecule) -> float:
    carbons = [a for a in mol.atoms if a.atomic_num == 6]
    if not carbons:
        return 0.0
    return sum(1 for a in carbons if a.hybridization == "SP3") / len(carbons)


# ---------------------------------------------------------------------------
# ring classification (SSSR-based, RDKit RingInfo semantics)
# ---------------------------------------------------------------------------

def _ring_infos(mol: Molecule):
    infos = []
    for ring in mol.symm_sssr():
        rset = set(ring)
        bonds = []
        n = len(ring)
        for i in range(n):
            b = mol.bond_between(ring[i], ring[(i + 1) % n])
            if b is not None:
                bonds.append(b)
        arom = all(b.is_aromatic or b.order == AROMATIC for b in bonds)
        saturated = all((not b.is_aromatic) and b.order == 1 for b in bonds)
        carbo = all(mol.atoms[a].atomic_num == 6 for a in rset)
        infos.append((arom, saturated, carbo))
    return infos


def ring_count(mol: Molecule) -> int:
    return len(mol.symm_sssr())


def num_aromatic_rings(mol: Molecule) -> int:
    return sum(1 for a, s, c in _ring_infos(mol) if a)


def num_aromatic_carbocycles(mol: Molecule) -> int:
    return sum(1 for a, s, c in _ring_infos(mol) if a and c)


def num_aromatic_heterocycles(mol: Molecule) -> int:
    return sum(1 for a, s, c in _ring_infos(mol) if a and not c)


def num_aliphatic_rings(mol: Molecule) -> int:
    return sum(1 for a, s, c in _ring_infos(mol) if not a)


def num_aliphatic_carbocycles(mol: Molecule) -> int:
    return sum(1 for a, s, c in _ring_infos(mol) if not a and c)


def num_aliphatic_heterocycles(mol: Molecule) -> int:
    return sum(1 for a, s, c in _ring_infos(mol) if not a and not c)


def num_saturated_rings(mol: Molecule) -> int:
    return sum(1 for a, s, c in _ring_infos(mol) if s)


def num_saturated_carbocycles(mol: Molecule) -> int:
    return sum(1 for a, s, c in _ring_infos(mol) if s and c)


def num_saturated_heterocycles(mol: Molecule) -> int:
    return sum(1 for a, s, c in _ring_infos(mol) if s and not c)


# ---------------------------------------------------------------------------
# Lipinski-style counts (SMARTS definitions as in rdkit Lipinski.py)
# ---------------------------------------------------------------------------

_HDONOR = ("[$([N;!H0;v3]),$([N;!H0;+1;v4]),$([O,S;H1;+0]),"
           "$([n;H1;+0])]")
_HACCEPTOR = ("[$([O,S;H1;v2]-[!$(*=[O,N,P,S])]),$([O,S;H0;v2]),"
              "$([O,S;-]),$([N;v3;!$(N-*=!@[O,N,P,S])]),"
              "$([nH0,o,s;+0])]")
# RDKit's STRICT rotatable-bond pattern (Lipinski.py strict definition —
# amide C-N, CX3 halide and t-Bu "rotors" excluded; validated against the
# vendored reference rdkit_2d outputs)
_ROTATABLE = (
    "[!$(*#*)&!D1&!$(C(F)(F)F)&!$(C(Cl)(Cl)Cl)&!$(C(Br)(Br)Br)"
    "&!$(C([CH3])([CH3])[CH3])"
    "&!$([CD3](=[N,O,S])-!@[#7,O,S!D1])"
    "&!$([#7,O,S!D1]-!@[CD3]=[N,O,S])"
    "&!$([CD3](=[N+])-!@[#7!D1])"
    "&!$([#7!D1]-!@[CD3]=[N+])]"
    "-!@[!$(*#*)&!D1&!$(C(F)(F)F)&!$(C(Cl)(Cl)Cl)&!$(C(Br)(Br)Br)"
    "&!$(C([CH3])([CH3])[CH3])]")


def num_h_donors(mol: Molecule) -> int:
    return len(match_all(mol, _HDONOR))


def num_h_acceptors(mol: Molecule) -> int:
    return len(match_all(mol, _HACCEPTOR))


def num_rotatable_bonds(mol: Molecule) -> int:
    return len(match_all(mol, _ROTATABLE))


def nhoh_count(mol: Molecule) -> int:
    """Number of N-H and O-H bonds (Lipinski.NHOHCount)."""
    return sum(a.num_hs for a in mol.atoms if a.atomic_num in (7, 8))


def no_count(mol: Molecule) -> int:
    return sum(1 for a in mol.atoms if a.atomic_num in (7, 8))


def num_heteroatoms(mol: Molecule) -> int:
    return sum(1 for a in mol.atoms if a.atomic_num not in (1, 6))


# ---------------------------------------------------------------------------
# TPSA (Ertl 2000 contributions; N/O only — RDKit default)
# ---------------------------------------------------------------------------

def _tpsa_contrib(mol: Molecule, idx: int) -> float:
    a = mol.atoms[idx]
    z, q, nh = a.atomic_num, a.formal_charge, a.num_hs
    if z not in (7, 8):
        return 0.0
    in3ring = any(len(r) == 3 and idx in r for r in mol.symm_sssr())
    # classify incident bonds (RDKit semantics: a bond is aromatic only
    # in a ring; aryl-aryl single links are SINGLE)
    s = d = t = ar = 0
    for b in mol.atom_bonds(idx):
        if (b.is_aromatic or b.order == AROMATIC) and b.in_ring:
            ar += 1
        else:
            order = (b.kekule_order if b.order == AROMATIC else b.order)
            if order == 1:
                s += 1
            elif order == 2:
                d += 1
            elif order == 3:
                t += 1
    if z == 7:
        if a.is_aromatic:
            if q == 0:
                if nh == 0:
                    if ar == 2 and s == 0 and d == 0:
                        return 12.89
                    if ar == 3:
                        return 4.41
                    if ar == 2 and s == 1:
                        return 4.93
                    if ar == 2 and d == 1:
                        return 8.39
                if nh == 1:
                    return 15.79
            elif q == 1:
                if nh == 0:
                    if ar == 3:
                        return 4.10
                    if ar == 2 and s == 1:
                        return 3.88
                if nh == 1:
                    return 14.14
        else:
            if q == 0:
                if nh == 0:
                    if s == 3 and d == 0 and t == 0:
                        return 3.01 if in3ring else 3.24
                    if s == 1 and d == 1:
                        return 12.36
                    if t == 1 and s == 0:
                        return 23.79
                    if s == 1 and d == 2:
                        return 11.68
                    if d == 1 and t == 1:
                        return 13.60
                if nh == 1:
                    if s == 2 and d == 0:
                        return 21.94 if in3ring else 12.03
                    if d == 1:
                        return 23.85
                if nh == 2 and s == 1:
                    return 26.02
            elif q == 1:
                if nh == 0:
                    if s == 4:
                        return 0.0
                    if s == 2 and d == 1:
                        return 3.01
                    if s == 1 and t == 1:
                        return 4.36
                if nh == 1:
                    if s == 3:
                        return 4.44
                    if s == 1 and d == 1:
                        return 13.97
                if nh == 2:
                    if s == 2:
                        return 16.61
                    if d == 1:
                        return 25.59
                if nh == 3 and s == 1:
                    return 27.64
        # fallback (Ertl's generic N contribution)
        v = 30.5 - (mol.degree(idx) + nh) * 8.2 + nh * 1.5
        return max(v, 0.0)
    # oxygen
    if a.is_aromatic:
        return 13.14
    if q == 0:
        if nh == 0:
            if s == 2 and d == 0:
                return 12.53 if in3ring else 9.23
            if d == 1 and s == 0:
                return 17.07
        if nh == 1 and s == 1:
            return 20.23
    elif q == -1 and s == 1 and d == 0 and nh == 0:
        return 23.06
    v = 28.5 - (mol.degree(idx) + nh) * 8.6 + nh * 1.5
    return max(v, 0.0)


def tpsa(mol: Molecule) -> float:
    return sum(_tpsa_contrib(mol, i) for i in range(mol.n_atoms))
