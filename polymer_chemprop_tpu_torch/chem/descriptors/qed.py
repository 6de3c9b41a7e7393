"""QED — quantitative estimate of drug-likeness (Bickerton et al.,
Nature Chemistry 2012), as in ``rdkit.Chem.QED``.

qed = exp( Σ w_i ln d_i / Σ w_i ) over 8 property desirability
functions (ADS: asymmetric double sigmoid) with the published parameter
table and the default weights (QED.weights_max in RDKit is the
*mean*-weight variant ``qed(mol)`` uses — w as below).
"""

from __future__ import annotations

import math

from ..mol import Molecule
from ..smarts import count_matches, match_all
from . import counts as C
from .crippen import mol_logp

# ADS parameter rows (a, b, c, d, e, f, dmax) per property —
# published QED supplementary table as shipped in rdkit.Chem.QED
_ADS_PARAMS = {
    "MW": (2.817065973, 392.5754953, 290.7489764, 2.419764353,
           49.22325677, 65.37051707, 104.9805561),
    "ALOGP": (3.172690585, 137.8624751, 2.534937431, 4.581497897,
              0.822739154, 0.576295591, 131.3186604),
    "HBA": (2.948620388, 160.4605972, 3.615294657, 4.435986202,
            0.290141953, 1.300669958, 148.7763046),
    "HBD": (1.618662227, 1010.051101, 0.985094388, 0.000000001,
            0.713820843, 0.920922555, 258.1632616),
    "PSA": (1.876861559, 125.2232657, 62.90773554, 87.83366614,
            12.01999824, 28.51324732, 104.5686167),
    "ROTB": (0.010000091, 272.4121427, 2.558379970, 1.565547684,
             1.271567166, 2.758063707, 105.4420403),
    "AROM": (3.217788970, 957.7374108, 2.274627939, 0.000000001,
             1.317690384, 0.375760881, 312.3372610),
    "ALERTS": (0.486849448, 186.2293718, 2.066177165, 3.902720615,
               1.027025453, 0.913012565, 145.4314800),
}
_WEIGHTS = {"MW": 0.66, "ALOGP": 0.46, "HBA": 0.05, "HBD": 0.61,
            "PSA": 0.06, "ROTB": 0.65, "AROM": 0.48, "ALERTS": 0.95}

# Structural alerts (Brenk filter subset used by QED); best-effort
# reconstruction — RDKit's QED.py ships 116 SMARTS that could not be
# fully recovered offline, and because the ALERTS desirability function
# PEAKS at ~2 alerts (the ADS was fit to approved drugs, which average
# 1-2 Brenk hits), a partial list distorts ranks in both directions —
# measured fidelity is recorded in tests/test_descriptors.py
# WEAK_COLUMNS["qed"] and docs/parity.md.
_ALERTS = [
    "*1[O,S,N]*1",                       # heteroatom 3-ring
    "[S,C](=[O,S])[F,Br,Cl,I]",          # acyl halide
    "[CX4][Cl,Br,I]",                    # alkyl halide
    "[C,c]S(=O)(=O)O[C,c]",              # sulfonate
    "[$([CH]),$(CC)]#CC(=O)[C,c]",
    "[$([CH]),$(CC)]#CC(=O)O[C,c]",
    "n[OH]",
    "C=C(C=O)C=O",
    "N#CC[OH]",
    "N#CC(=O)",
    "S(=O)(=O)C#N",
    "N[CH2]C#N",
    "C1(=O)OCC1",                        # beta-lactone
    "P(OC)(OC)=O",
    "N=[N+]=[N-]",                       # azide
    "C(=O)N[NH2]",
    "[N;R0][N;R0]C(=O)",                 # hydrazine-carbonyl
    "[C+,c+,C-,c-]",
    "N=[N+]=N",
    "C12C(NC(N1)=O)CSC2",
    "c1ccc2c(c1)ccc(=O)o2",              # coumarin
    "[O+,o+,S+,s+]",
    "N=C=O",                             # isocyanate
    "[NX3,NX4][F,Cl,Br,I]",
    "c1ccccc1OC(=O)[#6]",                # aryl ester
    "[SX2]O",
    "C(=O)Onnn",
    "OS(=O)(=O)C(F)(F)F",                # triflate
    "N#CC(=O)N",
    "SS",                                # disulfide
    "C1(=O)OC=CC1",
    "[SX2H0][N]",
    "c1ccccc1OC(=O)O",
    "[NX2+0]=[O+0]",                     # nitroso
    "N=NC(=O)",                          # azo-carbonyl
    "[OR0,NR0][OR0,NR0]",                # O/N-O/N acyclic
    "C(=O)N[OH]",
    "OO",                                # peroxide
    "C1NC(=O)NC(=O)1",
]


def _ads(x: float, p) -> float:
    a, b, c, d, e, f, dmax = p
    t1 = 1.0 + math.exp(-(x - c + d / 2.0) / e)
    t2 = 1.0 + math.exp(-(x - c - d / 2.0) / f)
    v = a + b / t1 * (1.0 - 1.0 / t2)
    return v / dmax


# QED's own acceptor definition (rdkit.Chem.QED Acceptors list — counted
# as distinct atoms matching any pattern, NOT Lipinski NumHAcceptors)
_ACCEPTORS = [
    "[oH0;X2]", "[OH1;X2;v2]", "[OH0;X2;v2]", "[OH0;X1;v2]", "[O-;X1]",
    "[NH0;X1;v3]", "[NH0;X3;v3]", "[NH1;X3;v3]", "[nH0;X2]", "[nH0;X3]",
    "[F;$(F-[#6]);!$(FC[F,Cl,Br,I])]",
]


def _num_acceptors(mol: Molecule) -> int:
    atoms = set()
    for sma in _ACCEPTORS:
        try:
            for mt in match_all(mol, sma):
                atoms |= set(mt)
        except ValueError:
            pass
    return len(atoms)


def qed(mol: Molecule) -> float:
    props = {
        "MW": C.mol_wt(mol),
        "ALOGP": mol_logp(mol),
        "HBA": _num_acceptors(mol),
        "HBD": C.num_h_donors(mol),
        "PSA": C.tpsa(mol),
        "ROTB": C.num_rotatable_bonds(mol),
        "AROM": C.num_aromatic_rings(mol),
        "ALERTS": sum(1 for s in _ALERTS if _safe_has(mol, s)),
    }
    num = 0.0
    den = 0.0
    for k, x in props.items():
        d = max(_ads(x, _ADS_PARAMS[k]), 1e-10)
        w = _WEIGHTS[k]
        num += w * math.log(d)
        den += w
    return math.exp(num / den)


def _safe_has(mol: Molecule, smarts: str) -> bool:
    try:
        return count_matches(mol, smarts) > 0
    except ValueError:
        return False
