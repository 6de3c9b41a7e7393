"""Assembly of the 200-descriptor ``rdkit_2d`` set.

Column names and order follow descriptastorus ``RDKIT_PROPS["1.0.0"]``
(reference features_generators.py:92-133): alphabetical by name with the
VSA families in lexicographic (string-sorted) numbering — verified
empirically column-by-column against the vendored reference outputs in
tests/data/regression.npz (tests/test_descriptors.py).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..mol import Molecule
from . import counts as C
from . import crippen as CR
from . import estate as E
from . import gasteiger as G
from . import topology as T
from . import vsa as V
from .fragments import FRAGMENT_NAMES, fragment_counts
from .qed import qed


def _lex(prefix: str, n: int) -> List[str]:
    return sorted(f"{prefix}{k}" for k in range(1, n + 1))


RDKIT2D_NAMES: List[str] = (
    ["BalabanJ", "BertzCT",
     "Chi0", "Chi0n", "Chi0v", "Chi1", "Chi1n", "Chi1v",
     "Chi2n", "Chi2v", "Chi3n", "Chi3v", "Chi4n", "Chi4v"]
    + _lex("EState_VSA", 11)
    + ["ExactMolWt", "FpDensityMorgan1", "FpDensityMorgan2",
       "FpDensityMorgan3", "FractionCSP3", "HallKierAlpha",
       "HeavyAtomCount", "HeavyAtomMolWt", "Ipc",
       "Kappa1", "Kappa2", "Kappa3", "LabuteASA",
       "MaxAbsEStateIndex", "MaxAbsPartialCharge", "MaxEStateIndex",
       "MaxPartialCharge", "MinAbsEStateIndex", "MinAbsPartialCharge",
       "MinEStateIndex", "MinPartialCharge",
       "MolLogP", "MolMR", "MolWt", "NHOHCount", "NOCount",
       "NumAliphaticCarbocycles", "NumAliphaticHeterocycles",
       "NumAliphaticRings", "NumAromaticCarbocycles",
       "NumAromaticHeterocycles", "NumAromaticRings",
       "NumHAcceptors", "NumHDonors", "NumHeteroatoms",
       "NumRadicalElectrons", "NumRotatableBonds",
       "NumSaturatedCarbocycles", "NumSaturatedHeterocycles",
       "NumSaturatedRings", "NumValenceElectrons"]
    + _lex("PEOE_VSA", 14)
    + ["RingCount"]
    + _lex("SMR_VSA", 10)
    + _lex("SlogP_VSA", 12)
    + ["TPSA"]
    + _lex("VSA_EState", 10)
    + FRAGMENT_NAMES
    + ["qed"]
)
assert len(RDKIT2D_NAMES) == 200, len(RDKIT2D_NAMES)


def _fp_density(mol: Molecule, radius: int) -> float:
    from ...features.generators import morgan_environments
    if mol.n_atoms == 0:
        return 0.0
    ids = morgan_environments(mol, radius)
    return len(set(ids)) / mol.n_atoms


def rdkit2d_raw_dict(mol: Molecule) -> Dict[str, float]:
    es = E.estate_indices(mol)
    q, _ = G.gasteiger_charges(mol)
    out: Dict[str, float] = {}
    out["BalabanJ"] = T.balaban_j(mol)
    out["BertzCT"] = T.bertz_ct(mol)
    out["Chi0"] = T.chi0(mol)
    out["Chi1"] = T.chi1(mol)
    for k in range(5):
        out[f"Chi{k}n"] = T.chi_nn(mol, k)
        out[f"Chi{k}v"] = T.chi_nv(mol, k)
    for name, val in zip(_lex("EState_VSA", 11),
                         _lex_values(V.estate_vsa(mol), 11)):
        out[name] = val
    out["ExactMolWt"] = C.exact_mol_wt(mol)
    for r in (1, 2, 3):
        out[f"FpDensityMorgan{r}"] = _fp_density(mol, r)
    out["FractionCSP3"] = C.fraction_csp3(mol)
    out["HallKierAlpha"] = T.hall_kier_alpha(mol)
    out["HeavyAtomCount"] = mol.n_atoms
    out["HeavyAtomMolWt"] = C.heavy_atom_mol_wt(mol)
    out["Ipc"] = T.ipc(mol)
    out["Kappa1"] = T.kappa1(mol)
    out["Kappa2"] = T.kappa2(mol)
    out["Kappa3"] = T.kappa3(mol)
    out["LabuteASA"] = V.labute_asa(mol)
    out["MaxAbsEStateIndex"] = max((abs(x) for x in es), default=0.0)
    out["MaxAbsPartialCharge"] = G.max_abs_partial_charge(mol)
    out["MaxEStateIndex"] = max(es, default=0.0)
    out["MaxPartialCharge"] = max(q, default=0.0)
    out["MinAbsEStateIndex"] = min((abs(x) for x in es), default=0.0)
    out["MinAbsPartialCharge"] = G.min_abs_partial_charge(mol)
    out["MinEStateIndex"] = min(es, default=0.0)
    out["MinPartialCharge"] = min(q, default=0.0)
    out["MolLogP"] = CR.mol_logp(mol)
    out["MolMR"] = CR.mol_mr(mol)
    out["MolWt"] = C.mol_wt(mol)
    out["NHOHCount"] = C.nhoh_count(mol)
    out["NOCount"] = C.no_count(mol)
    out["NumAliphaticCarbocycles"] = C.num_aliphatic_carbocycles(mol)
    out["NumAliphaticHeterocycles"] = C.num_aliphatic_heterocycles(mol)
    out["NumAliphaticRings"] = C.num_aliphatic_rings(mol)
    out["NumAromaticCarbocycles"] = C.num_aromatic_carbocycles(mol)
    out["NumAromaticHeterocycles"] = C.num_aromatic_heterocycles(mol)
    out["NumAromaticRings"] = C.num_aromatic_rings(mol)
    out["NumHAcceptors"] = C.num_h_acceptors(mol)
    out["NumHDonors"] = C.num_h_donors(mol)
    out["NumHeteroatoms"] = C.num_heteroatoms(mol)
    out["NumRadicalElectrons"] = 0
    out["NumRotatableBonds"] = C.num_rotatable_bonds(mol)
    out["NumSaturatedCarbocycles"] = C.num_saturated_carbocycles(mol)
    out["NumSaturatedHeterocycles"] = C.num_saturated_heterocycles(mol)
    out["NumSaturatedRings"] = C.num_saturated_rings(mol)
    out["NumValenceElectrons"] = C.num_valence_electrons(mol)
    for name, val in zip(_lex("PEOE_VSA", 14),
                         _lex_values(V.peoe_vsa(mol), 14)):
        out[name] = val
    out["RingCount"] = C.ring_count(mol)
    for name, val in zip(_lex("SMR_VSA", 10),
                         _lex_values(V.smr_vsa(mol), 10)):
        out[name] = val
    for name, val in zip(_lex("SlogP_VSA", 12),
                         _lex_values(V.slogp_vsa(mol), 12)):
        out[name] = val
    out["TPSA"] = C.tpsa(mol)
    for name, val in zip(_lex("VSA_EState", 10),
                         _lex_values(V.vsa_estate(mol), 10)):
        out[name] = val
    for name, val in zip(FRAGMENT_NAMES, fragment_counts(mol)):
        out[name] = val
    out["qed"] = qed(mol)
    return out


def _lex_values(vals: List[float], n: int) -> List[float]:
    """Reorder 1..n bin values into lexicographic name order."""
    perm = [int(nm) - 1 for nm in sorted(str(k) for k in range(1, n + 1))]
    return [vals[p] for p in perm]


def rdkit2d_raw(mol: Molecule) -> np.ndarray:
    d = rdkit2d_raw_dict(mol)
    return np.array([float(d[nm]) for nm in RDKIT2D_NAMES],
                    dtype=np.float64)
