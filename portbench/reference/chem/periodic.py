# Frozen copy of polymer_chemprop_tpu_torch/chem/periodic.py, the benchmark reference's
# own featurizer: later changes to the port do not reach it.
"""Periodic-table data for the standalone chemistry runtime.

The reference implementation delegates all chemistry to RDKit's C++ core
(reference chemprop/rdkit.py, chemprop/features/featurization.py:7).
This framework has no RDKit dependency: the tables below back the SMILES
parser and perception algorithms in :mod:`polymer_chemprop_tpu_torch.chem`.

Masses are IUPAC 2021 standard atomic weights (abridged), matching what
``atom.GetMass()`` returns in RDKit closely enough for the 0.01*mass
feature channel used by the featurizer (reference featurization.py:208).
"""

from __future__ import annotations

# symbol -> atomic number
SYMBOL_TO_NUM = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22,
    "V": 23, "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29,
    "Zn": 30, "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36,
    "Rb": 37, "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43,
    "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50,
    "Sb": 51, "Te": 52, "I": 53, "Xe": 54, "Cs": 55, "Ba": 56, "La": 57,
    "Ce": 58, "Pr": 59, "Nd": 60, "Pm": 61, "Sm": 62, "Eu": 63, "Gd": 64,
    "Tb": 65, "Dy": 66, "Ho": 67, "Er": 68, "Tm": 69, "Yb": 70, "Lu": 71,
    "Hf": 72, "Ta": 73, "W": 74, "Re": 75, "Os": 76, "Ir": 77, "Pt": 78,
    "Au": 79, "Hg": 80, "Tl": 81, "Pb": 82, "Bi": 83, "Po": 84, "At": 85,
    "Rn": 86, "Fr": 87, "Ra": 88, "Ac": 89, "Th": 90, "Pa": 91, "U": 92,
    "Np": 93, "Pu": 94, "Am": 95, "Cm": 96, "Bk": 97, "Cf": 98, "Es": 99,
    "Fm": 100, "Md": 101, "No": 102, "Lr": 103, "Rf": 104, "Db": 105,
    "Sg": 106, "Bh": 107, "Hs": 108, "Mt": 109, "Ds": 110, "Rg": 111,
    "Cn": 112, "Nh": 113, "Fl": 114, "Mc": 115, "Lv": 116, "Ts": 117,
    "Og": 118,
    # wildcard / dummy atom (RDKit atomic number 0)
    "*": 0,
}

NUM_TO_SYMBOL = {v: k for k, v in SYMBOL_TO_NUM.items()}

# Standard atomic weights. Index by atomic number.
ATOMIC_MASS = {
    0: 0.0, 1: 1.008, 2: 4.003, 3: 6.941, 4: 9.012, 5: 10.811, 6: 12.011,
    7: 14.007, 8: 15.999, 9: 18.998, 10: 20.180, 11: 22.990, 12: 24.305,
    13: 26.982, 14: 28.086, 15: 30.974, 16: 32.067, 17: 35.453, 18: 39.948,
    19: 39.098, 20: 40.078, 21: 44.956, 22: 47.867, 23: 50.942, 24: 51.996,
    25: 54.938, 26: 55.845, 27: 58.933, 28: 58.693, 29: 63.546, 30: 65.39,
    31: 69.723, 32: 72.61, 33: 74.922, 34: 78.96, 35: 79.904, 36: 83.80,
    37: 85.468, 38: 87.62, 39: 88.906, 40: 91.224, 41: 92.906, 42: 95.94,
    43: 98.0, 44: 101.07, 45: 102.906, 46: 106.42, 47: 107.868, 48: 112.412,
    49: 114.818, 50: 118.711, 51: 121.760, 52: 127.60, 53: 126.904,
    54: 131.29, 55: 132.905, 56: 137.328, 57: 138.906, 58: 140.116,
    59: 140.908, 60: 144.24, 61: 145.0, 62: 150.36, 63: 151.964, 64: 157.25,
    65: 158.925, 66: 162.50, 67: 164.930, 68: 167.26, 69: 168.934,
    70: 173.04, 71: 174.967, 72: 178.49, 73: 180.948, 74: 183.84,
    75: 186.207, 76: 190.23, 77: 192.217, 78: 195.078, 79: 196.967,
    80: 200.59, 81: 204.383, 82: 207.2, 83: 208.980, 84: 209.0, 85: 210.0,
    86: 222.0, 87: 223.0, 88: 226.0, 89: 227.0, 90: 232.038, 91: 231.036,
    92: 238.029, 93: 237.0, 94: 244.0, 95: 243.0, 96: 247.0, 97: 247.0,
    98: 251.0, 99: 252.0, 100: 257.0, 101: 258.0, 102: 259.0, 103: 262.0,
}


def atomic_mass(num: int, isotope: int = 0) -> float:
    """Mass of an atom; an explicit isotope label overrides the standard weight."""
    if isotope:
        return float(isotope)
    return ATOMIC_MASS.get(num, float(num) * 2.0)


# Default valences for the implicit-hydrogen model, in increasing order.
# Organic-subset atoms fill hydrogens up to the lowest valence >= current
# bond-order sum (OpenSMILES semantics; mirrors RDKit's valence model).
DEFAULT_VALENCES = {
    1: (1,),          # H
    5: (3,),          # B
    6: (4,),          # C
    7: (3, 5),        # N  (RDKit fills to 3; 5 accepted for e.g. nitro N(=O)=O)
    8: (2,),          # O
    9: (1,),          # F
    15: (3, 5),       # P
    16: (2, 4, 6),    # S
    17: (1,),         # Cl
    35: (1,),         # Br
    53: (1,),         # I
}

# Elements allowed outside brackets in SMILES (the "organic subset").
ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
AROMATIC_ORGANIC = {"b", "c", "n", "o", "p", "s"}
# Elements that may carry the aromatic (lowercase) flag inside brackets.
AROMATIC_OK = {5, 6, 7, 8, 14, 15, 16, 33, 34, 52}

# Number of outer-shell (valence) electrons by group, for lone-pair counting
# in the hybridization model.
_OUTER = {
    1: 1, 2: 2,
    3: 1, 4: 2, 5: 3, 6: 4, 7: 5, 8: 6, 9: 7, 10: 8,
    11: 1, 12: 2, 13: 3, 14: 4, 15: 5, 16: 6, 17: 7, 18: 8,
    19: 1, 20: 2, 31: 3, 32: 4, 33: 5, 34: 6, 35: 7, 36: 8,
    37: 1, 38: 2, 49: 3, 50: 4, 51: 5, 52: 6, 53: 7, 54: 8,
    55: 1, 56: 2, 81: 3, 82: 4, 83: 5, 84: 6, 85: 7, 86: 8,
}


def outer_electrons(num: int) -> int:
    """Valence-shell electron count (main-group; transition metals -> 0 lone pairs)."""
    return _OUTER.get(num, 2)


def default_valence(num: int, charge: int = 0) -> tuple:
    """Allowed valences of an element adjusted for formal charge.

    For a positive charge on N/O/S/P-like elements the valence increases by
    one (e.g. N+ -> 4); for a negative charge it decreases (e.g. C- -> 3,
    N- -> 2, O- -> 1). Elements without an entry get no implicit hydrogens.
    """
    base = DEFAULT_VALENCES.get(num)
    if base is None:
        return ()
    if charge == 0:
        return base
    outer = outer_electrons(num)
    # Daylight-style rule: removing an electron from an element right of
    # carbon (outer > 4) frees a bonding site (N+ -> 4, O+ -> 3); adding one
    # gains a lone pair (N- -> 2, O- -> 1). For carbon both signs lose a bond
    # -site or gain a lone pair (C+ -> 3, C- -> 3). Left of carbon it is the
    # mirror image (B- -> 4, B+ -> 2).
    if charge > 0:
        if outer > 4:
            return tuple(v + charge for v in base)
        return tuple(max(0, v - charge) for v in base)
    if outer >= 4:
        return tuple(max(0, v + charge) for v in base)
    return tuple(max(0, v - charge) for v in base)
