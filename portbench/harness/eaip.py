"""Frozen copy of the copolymer generator of polymer_chemprop_tpu_torch/eaip.py
(the reconstructed EA/IP benchmark of Aldeghi & Coley, Chem. Sci. 2022, 13,
10486): nine monomers, three stoichiometries, three chain architectures and
Xn 5/10/50, 972 ensemble strings in the reference's grammar with surrogate
EA and IP labels. The benchmark's wD-MPNN cells draw their copolymers from
here, so later changes to the port's module do not change the data.
"""

from __future__ import annotations

import hashlib
import itertools
import math
from typing import List, Tuple

# (name, ensemble SMILES with [*:1]/[*:2], electron-affinity group score,
#  ionization group score): crude Hammett-flavoured tallies, not xTB values
MONOMERS = [
    ("DBTS", "[*:1]c1ccc2c(c1)S(=O)(=O)c1cc([*:2])ccc1-2", 1.9, 7.4),
    ("FLUOR", "[*:1]c1ccc2c(c1)C(C)(C)c1cc([*:2])ccc1-2", 0.9, 6.9),
    ("CARB", "[*:1]c1ccc2c(c1)[nH]c1cc([*:2])ccc12", 0.5, 6.2),
    ("PHEN", "[*:1]c1ccc([*:2])cc1", 1.0, 7.0),
    ("BTD", "[*:1]c1ccc2nsnc2c1[*:2]", 2.6, 7.8),
    ("THIO", "[*:1]c1ccc([*:2])s1", 1.2, 6.6),
    ("BIPY", "[*:1]c1ccc(-c2ccc([*:2])nc2)nc1", 2.0, 7.6),
    ("DBF", "[*:1]c1ccc2c(c1)oc1cc([*:2])ccc12", 1.1, 7.1),
    ("ANIL", "[*:1]c1ccc([*:2])c(N)c1", 0.4, 5.9),
]

ARCHITECTURES = ("alternating", "block", "random")
STOICHIOMETRIES = ((0.25, 0.75), (0.5, 0.5), (0.75, 0.25))
XNS = (5, 10, 50)
HEADER = ("smiles", "EA", "IP")

Row = Tuple[str, float, float]


def bonds_for(arch: str, fa: float, fb: float):
    """The stochastic bonds of an architecture, in the reference's directed
    convention (``<i-j:w_ij:w_ji``, w_ij the weight of the i->j edge, so
    incoming to j). Every attachment point's incoming weights sum to 1.
    Monomer A carries tags 1 and 2, B tags 3 and 4."""
    if arch == "alternating":
        # A bonds only B: each end draws uniformly from the partner's ends
        return [("1-3", 0.5, 0.5), ("1-4", 0.5, 0.5),
                ("2-3", 0.5, 0.5), ("2-4", 0.5, 0.5)]
    if arch == "block":
        # long homo-blocks: strong self coupling, a rare A-B interface
        return [("1-2", 0.85, 0.85), ("3-4", 0.85, 0.85),
                ("1-3", 0.075, 0.075), ("1-4", 0.075, 0.075),
                ("2-3", 0.075, 0.075), ("2-4", 0.075, 0.075)]
    # random: the next unit is A with probability fa, B with fb; the
    # directed weights differ (into an A-end: fa from A, fb/2 from each
    # B-end; into a B-end: fb from B, fa/2 from each A-end)
    return [("1-2", fa, fa), ("3-4", fb, fb),
            ("1-3", fa / 2, fb / 2), ("1-4", fa / 2, fb / 2),
            ("2-3", fa / 2, fb / 2), ("2-4", fa / 2, fb / 2)]


def ensemble_string(smi_a: str, smi_b: str, fa: float, fb: float,
                    arch: str, xn: int) -> str:
    b = smi_b.replace("[*:1]", "[*:3]").replace("[*:2]", "[*:4]")
    rules = "".join(f"<{ij}:{wij:.6g}:{wji:.6g}"
                    for ij, wij, wji in bonds_for(arch, fa, fb)
                    if wij > 0 or wji > 0)
    return f"{smi_a}.{b}|{fa:.6g}|{fb:.6g}|{rules}~{xn}"


def _hash_unit(*key) -> float:
    h = hashlib.sha256(repr(key).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


def labels_for(name_a, ea_a, ip_a, name_b, ea_b, ip_b, fa, fb, arch, xn):
    """Surrogate EA and IP (eV): composition-weighted group scores, an
    interface term that depends on the architecture (donor-acceptor
    alternation raises EA; blocks behave like the separate homopolymers),
    a conjugation-length term in 1 + log10(Xn) and a deterministic
    residual a copolymer (about 0.05 eV RMS, standing in for xTB noise)."""
    push_pull = 0.35 + abs(ea_a - ea_b) * 0.35
    interface = {"alternating": 1.0, "random": 2 * fa * fb,
                 "block": 0.15}[arch]
    conj = 1.0 + math.log10(xn)
    ea = (fa * ea_a + fb * ea_b) + push_pull * interface \
        + 0.18 * conj - 0.45
    ip = (fa * ip_a + fb * ip_b) - 0.5 * push_pull * interface \
        - 0.12 * conj + 0.35
    ea += 0.06 * (_hash_unit("ea", name_a, name_b, fa, arch, xn) - 0.5)
    ip += 0.06 * (_hash_unit("ip", name_a, name_b, fa, arch, xn) - 0.5)
    return ea, ip


def generate(blind_weights: bool = False) -> List[Row]:
    """The 972 copolymers as (ensemble string, EA, IP). With
    ``blind_weights`` every string takes the alternating bond weights
    (the architecture-blind arm: the same monomers, stoichiometry and Xn,
    uniform weights) while the labels keep their architecture."""
    rows = []
    for (na, sa, ea_a, ip_a), (nb, sb, ea_b, ip_b) in \
            itertools.combinations(MONOMERS, 2):
        for fa, fb in STOICHIOMETRIES:
            for arch in ARCHITECTURES:
                for xn in XNS:
                    s = ensemble_string(sa, sb, fa, fb,
                                        "alternating" if blind_weights
                                        else arch, xn)
                    ea, ip = labels_for(na, ea_a, ip_a, nb, ea_b, ip_b,
                                        fa, fb, arch, xn)
                    rows.append((s, ea, ip))
    return rows
