"""Atom/bond featurization and per-molecule graph construction.

Produces feature vectors with *identical layout and vocabulary* to the
reference (featurization.py:190-250: 133-dim atoms, 14-dim bonds) and the
same graph index structure (directed bond pairs, reverse-edge pairing,
stochastic polymer edges) — but emits flat numpy arrays in a segment-sum
layout (``b2dst`` destination ids) designed for segment reductions over a dst-sorted bond list
instead of the reference's ragged ``a2b`` incoming-bond lists
(featurization.py:423, consumed via dense max-degree padding at :809).

Polymer mode follows reference featurization.py:489-637: atom features are
computed with wildcard attachment points still bonded (correct saturation),
wildcards are then removed, intra-monomer bonds get unit weights, and
stochastic inter-monomer bonds get the directed weights from the polymer
rules. Unlike the reference we do not CombineMols+sanitize per stochastic
bond (an O(atoms) RDKit call per edge, :603-633); inter-monomer bond
features are computed directly (never in-ring, conjugation from pi
-adjacency of the two attachment atoms).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..chem import parse_smiles
from ..chem.mol import (
    AROMATIC,
    Atom,
    Bond,
    DOUBLE,
    Molecule,
    SINGLE,
    TRIPLE,
)
from .config import ATOM_FEATURES, ATOM_FDIM, BOND_FDIM, MAX_ATOMIC_NUM, FeaturizationConfig


# --------------------------------------------------------------------------
# molecule construction (reference chemprop/rdkit.py)
# --------------------------------------------------------------------------

def make_mol(smiles: str, keep_h: bool = False, add_h: bool = False) -> Optional[Molecule]:
    """Build a perceived Molecule from SMILES (reference rdkit.py:3-18)."""
    return parse_smiles(smiles, keep_h=keep_h, add_h=add_h, strict=False)


def make_polymer_mol(smiles: str, keep_h: bool, add_h: bool,
                     fragment_weights: Sequence[str]) -> Molecule:
    """Build a multi-fragment polymer molecule with per-atom ``w_frag``
    stoichiometry weights (reference rdkit.py:21-51)."""
    num_frags = len(smiles.split("."))
    if len(fragment_weights) != num_frags:
        raise ValueError(
            f"number of input monomers/fragments ({num_frags}) does not match "
            f"number of input number of fragment weights ({len(fragment_weights)})")
    combined = Molecule()
    offset = 0
    for frag, w in zip(smiles.split("."), fragment_weights):
        m = parse_smiles(frag, keep_h=keep_h, add_h=add_h, strict=True)
        for a in m.atoms:
            a.props["w_frag"] = float(w)
        # append fragment into the combined molecule (CombineMols equivalent)
        for a in m.atoms:
            na = Atom(atomic_num=a.atomic_num, formal_charge=a.formal_charge,
                      is_aromatic=a.is_aromatic, chiral_tag=a.chiral_tag,
                      isotope=a.isotope, explicit_hs=a.explicit_hs,
                      props=dict(a.props))
            combined.add_atom(na)
        for b in m.bonds:
            combined.add_bond(b.a1 + offset, b.a2 + offset, b.order,
                              is_aromatic=b.is_aromatic, direction=b.direction)
        offset += m.n_atoms
    combined.perceive()
    return combined


# --------------------------------------------------------------------------
# feature vectors (reference featurization.py:174-250)
# --------------------------------------------------------------------------

def onek_encoding_unk(value, choices: list) -> List[int]:
    """One-hot with trailing unknown slot (reference featurization.py:174-187)."""
    encoding = [0] * (len(choices) + 1)
    index = choices.index(value) if value in choices else -1
    encoding[index] = 1
    return encoding


def atom_features(mol: Optional[Molecule], atom_idx: Optional[int]) -> List[float]:
    """133-dim atom feature vector (reference featurization.py:190-211)."""
    if mol is None or atom_idx is None:
        return [0] * ATOM_FDIM
    atom = mol.atoms[atom_idx]
    return (
        onek_encoding_unk(atom.atomic_num - 1, ATOM_FEATURES["atomic_num"])
        + onek_encoding_unk(mol.total_degree(atom_idx), ATOM_FEATURES["degree"])
        + onek_encoding_unk(atom.formal_charge, ATOM_FEATURES["formal_charge"])
        + onek_encoding_unk(atom.chiral_tag, ATOM_FEATURES["chiral_tag"])
        + onek_encoding_unk(atom.num_hs, ATOM_FEATURES["num_Hs"])
        + onek_encoding_unk(atom.hybridization, ATOM_FEATURES["hybridization"])
        + [1 if atom.is_aromatic else 0]
        + [atom.mass * 0.01]
    )


def atom_features_zeros(mol: Optional[Molecule], atom_idx: Optional[int]) -> List[float]:
    """Atomic-number-only features, rest zeroed (reference :214-226, reaction mode)."""
    if mol is None or atom_idx is None:
        return [0] * ATOM_FDIM
    atom = mol.atoms[atom_idx]
    return (onek_encoding_unk(atom.atomic_num - 1, ATOM_FEATURES["atomic_num"])
            + [0] * (ATOM_FDIM - MAX_ATOMIC_NUM - 1))


def bond_features(bond: Optional[Bond]) -> List[float]:
    """14-dim bond feature vector (reference featurization.py:229-250)."""
    if bond is None:
        return [1] + [0] * (BOND_FDIM - 1)
    order = bond.order
    return [
        0,
        1 if (order == SINGLE and not bond.is_aromatic) else 0,
        1 if (order == DOUBLE and not bond.is_aromatic) else 0,
        1 if order == TRIPLE else 0,
        1 if (order == AROMATIC or bond.is_aromatic) else 0,
        1 if bond.conjugated else 0,
        1 if bond.in_ring else 0,
    ] + onek_encoding_unk(bond.stereo, list(range(6)))


def _synthetic_bond_features(mol: Molecule, a1: int, a2: int, order: int) -> List[float]:
    """Features of a stochastic inter-monomer bond as if it were added between
    two monomer copies (reference featurization.py:597-614 uses
    CombineMols+AddBond+Sanitize; we compute the same outcome directly: the
    new bond joins two copies so it is never in a ring and carries no
    stereo; conjugation follows the pair-marking rule — the new bond is
    conjugated when one end carries a multiple/aromatic bond and the other
    end is a pi center)."""
    def has_multiple(a: int) -> bool:
        return any(b.order in (DOUBLE, TRIPLE, AROMATIC) or b.is_aromatic
                   for b in mol.atom_bonds(a))

    b = Bond(a1=a1, a2=a2, order=order)
    b.in_ring = False
    b.stereo = 0
    b.is_aromatic = False
    if order in (DOUBLE, TRIPLE):
        # the new multiple bond is conjugated if either end has a sibling
        # pi-center neighbour
        b.conjugated = any(mol._pi_center(nb) for nb in
                           (mol.neighbors(a1) + mol.neighbors(a2)))
    else:
        b.conjugated = (has_multiple(a1) and mol._pi_center(a2)) or \
                       (has_multiple(a2) and mol._pi_center(a1))
    return bond_features(b)


# --------------------------------------------------------------------------
# polymer helpers (reference featurization.py:286-364)
# --------------------------------------------------------------------------

def tag_atoms_in_repeating_unit(mol: Molecule) -> Tuple[Molecule, Dict[str, int]]:
    """Tag core vs wildcard atoms and map R-group tags to attachment-bond
    orders (reference featurization.py:286-323). Mutates atom props:
    ``core`` bool and ``R`` list of tags like '*1'."""
    neighbor_map: Dict[str, int] = {}
    r_bond_types: Dict[str, int] = {}
    for atom in mol.atoms:
        if atom.is_wildcard():
            neighbors = mol.neighbors(atom.idx)
            assert len(neighbors) == 1
            r_tag = f"*{atom.props.get('atom_map', '')}"
            neighbor_map[r_tag] = neighbors[0]
            atom.props["core"] = False
            bond = mol.bond_between(atom.idx, neighbors[0])
            r_bond_types[r_tag] = bond.order
        else:
            atom.props["core"] = True
    for atom in mol.atoms:
        atom.props["R"] = [k for k, v in neighbor_map.items() if v == atom.idx]
    return mol, r_bond_types


def parse_polymer_rules(rules: List[str]) -> Tuple[List[Tuple[str, str, float, float]], float]:
    """Parse '<i-j:wij:wji' monomer-connection rules and optional '~Xn'
    degree of polymerization (reference featurization.py:335-364).

    Returns (polymer_info, 1 + log10(Xn))."""
    polymer_info = []
    counter: Dict[str, float] = {}
    rules = list(rules)
    if rules and "~" in rules[-1]:
        xn = float(rules[-1].split("~")[1])
        rules[-1] = rules[-1].split("~")[0]
    else:
        xn = 1.0
    for rule in rules:
        if rule == "":
            continue
        if len(rule.split(":")) != 3:
            raise ValueError(f'incorrect format for input information "{rule}"')
        idx1, idx2 = rule.split(":")[0].split("-")
        w12 = float(rule.split(":")[1])
        w21 = float(rule.split(":")[2])
        polymer_info.append((idx1, idx2, w12, w21))
        counter[idx1] = counter.get(idx1, 0.0) + w21
        counter[idx2] = counter.get(idx2, 0.0) + w12
    for k, v in counter.items():
        if not np.isclose(v, 1.0):
            # The reference intends to reject such inputs but its check
            # ``np.isclose(v, 1.0) is False`` compares a numpy bool to the
            # Python False singleton and never fires (featurization.py:362)
            # — its own README example (sum 1.25 for [*:1]) relies on that.
            # We warn instead of raising to accept the same inputs.
            import warnings
            warnings.warn(
                f"sum of weights of incoming stochastic edges should be 1 -- "
                f"found {v} for [*:{k}]")
    return polymer_info, 1.0 + math.log10(xn)


def remove_wildcard_atoms(mol: Molecule) -> Molecule:
    """Drop wildcard atoms and re-perceive (reference featurization.py:326-332)."""
    while True:
        idx = next((a.idx for a in mol.atoms if a.is_wildcard()), None)
        if idx is None:
            break
        mol.remove_atom(idx)
    mol.perceive()
    return mol


# --------------------------------------------------------------------------
# MolGraph (reference featurization.py:367-740)
# --------------------------------------------------------------------------

class MolGraph:
    """Graph structure + features of a single datapoint.

    Attributes mirror the reference MolGraph (featurization.py:371-427) with
    one addition: ``b2dst`` (destination atom of each directed bond), the
    segment ids used by the encoder's segment-sum message aggregation in
    place of ragged ``a2b`` lists.
    """

    def __init__(self, mol: Union[str, Molecule, tuple],
                 config: FeaturizationConfig = FeaturizationConfig(),
                 atom_features_extra: Optional[np.ndarray] = None,
                 bond_features_extra: Optional[np.ndarray] = None):
        self.config = config
        self.is_polymer = config.polymer
        self.is_reaction = config.reaction

        if isinstance(mol, str):
            if config.reaction:
                mol = (make_mol(mol.split(">")[0], config.explicit_h, config.adding_h),
                       make_mol(mol.split(">")[-1], config.explicit_h, config.adding_h))
            elif config.polymer:
                mol = (make_polymer_mol(mol.split("|")[0], config.explicit_h,
                                        config.adding_h,
                                        fragment_weights=mol.split("|")[1:-1]),
                       mol.split("<")[1:])
            else:
                mol = make_mol(mol, config.explicit_h, config.adding_h)

        self.n_atoms = 0
        self.n_bonds = 0
        self.degree_of_polym = 1.0
        self.f_atoms: List[List[float]] = []
        self.f_bonds: List[List[float]] = []
        self.w_atoms: List[float] = []
        self.w_bonds: List[float] = []
        self.b2a: List[int] = []     # bond -> source atom
        self.b2dst: List[int] = []   # bond -> destination atom
        self.b2revb: List[int] = []  # bond -> reverse bond
        self.polymer_info = []

        overwrite_atom = config.overwrite_default_atom_features
        overwrite_bond = config.overwrite_default_bond_features

        if not self.is_reaction and not self.is_polymer:
            self._build_standard(mol, atom_features_extra, bond_features_extra,
                                 overwrite_atom, overwrite_bond)
        elif self.is_polymer:
            self._build_polymer(mol, atom_features_extra, bond_features_extra,
                                overwrite_atom, overwrite_bond)
        else:
            self._build_reaction(mol)

    # -- shared: add the directed pair for one undirected bond --------------
    def _add_bond_pair(self, a1: int, a2: int, f_bond: List[float],
                       w12: float = 1.0, w21: float = 1.0) -> None:
        """Add directed bonds a1->a2 then a2->a1 with the reference's
        feature concatenation f_bonds[b] = f_atoms[src] + f_bond
        (featurization.py:467-480) and index bookkeeping."""
        self.f_bonds.append(self.f_atoms[a1] + f_bond)
        self.f_bonds.append(self.f_atoms[a2] + f_bond)
        b1 = self.n_bonds
        b2 = b1 + 1
        self.b2a.extend([a1, a2])
        self.b2dst.extend([a2, a1])
        self.b2revb.extend([b2, b1])
        self.w_bonds.extend([w12, w21])
        self.n_bonds += 2

    def _build_standard(self, mol: Molecule, atom_features_extra,
                        bond_features_extra, overwrite_atom, overwrite_bond):
        if mol is None:
            raise ValueError("invalid molecule")
        self.f_atoms = [atom_features(mol, a.idx) for a in mol.atoms]
        self.w_atoms = [1.0] * mol.n_atoms
        if atom_features_extra is not None:
            if overwrite_atom:
                self.f_atoms = [d.tolist() for d in atom_features_extra]
            else:
                self.f_atoms = [f + d.tolist() for f, d in
                                zip(self.f_atoms, atom_features_extra)]
            if len(atom_features_extra) != len(mol.atoms):
                raise ValueError("number of atoms differs from extra atom features")
        self.n_atoms = len(self.f_atoms)

        # enumerate undirected bonds in (a1, a2) sorted order like the
        # reference's pairwise scan (featurization.py:452-480)
        for bond in sorted(mol.bonds, key=lambda b: (min(b.a1, b.a2), max(b.a1, b.a2))):
            a1, a2 = min(bond.a1, bond.a2), max(bond.a1, bond.a2)
            f_bond = bond_features(bond)
            if bond_features_extra is not None:
                descr = bond_features_extra[bond.idx].tolist()
                f_bond = descr if overwrite_bond else f_bond + descr
            self._add_bond_pair(a1, a2, f_bond)

        if bond_features_extra is not None and len(bond_features_extra) != self.n_bonds / 2:
            raise ValueError("number of bonds differs from extra bond features")

    def _build_polymer(self, mol: tuple, atom_features_extra,
                       bond_features_extra, overwrite_atom, overwrite_bond):
        m: Molecule = mol[0]
        rules: List[str] = mol[1]
        self.polymer_info, self.degree_of_polym = parse_polymer_rules(rules)
        m = m.copy()
        m, r_bond_types = tag_atoms_in_repeating_unit(m)

        # atom features with wildcards still attached -> correct saturation
        # (reference featurization.py:504-507)
        self.f_atoms = [atom_features(m, a.idx) for a in m.atoms if a.props["core"]]
        self.w_atoms = [a.props["w_frag"] for a in m.atoms if a.props["core"]]
        if atom_features_extra is not None:
            if overwrite_atom:
                self.f_atoms = [d.tolist() for d in atom_features_extra]
            else:
                self.f_atoms = [f + d.tolist() for f, d in
                                zip(self.f_atoms, atom_features_extra)]
        self.n_atoms = len(self.f_atoms)
        if atom_features_extra is not None and len(atom_features_extra) != self.n_atoms:
            raise ValueError("number of atoms differs from extra atom features")

        # remove wildcards; remaining atom order matches f_atoms order
        # (reference featurization.py:520-521)
        remove_wildcard_atoms(m)

        # intra-monomer bonds, unit weights (reference :530-558)
        for bond in sorted(m.bonds, key=lambda b: (min(b.a1, b.a2), max(b.a1, b.a2))):
            a1, a2 = min(bond.a1, bond.a2), max(bond.a1, bond.a2)
            f_bond = bond_features(bond)
            if bond_features_extra is not None:
                descr = bond_features_extra[bond.idx].tolist()
                f_bond = descr if overwrite_bond else f_bond + descr
            self._add_bond_pair(a1, a2, f_bond)

        # stochastic inter-monomer bonds with directed weights (reference :573-633)
        for r1, r2, w12, w21 in self.polymer_info:
            a1 = a2 = None
            for atom in m.atoms:
                if f"*{r1}" in atom.props.get("R", []):
                    a1 = atom.idx
                if f"*{r2}" in atom.props.get("R", []):
                    a2 = atom.idx
            if a1 is None:
                raise ValueError(f"cannot find atom attached to [*:{r1}]")
            if a2 is None:
                raise ValueError(f"cannot find atom attached to [*:{r2}]")
            order1 = r_bond_types[f"*{r1}"]
            order2 = r_bond_types[f"*{r2}"]
            if order1 != order2:
                raise ValueError(
                    f"two atoms are trying to be bonded with different bond "
                    f"types: {order1} vs {order2}")
            f_bond = _synthetic_bond_features(m, a1, a2, order1)
            if bond_features_extra is not None:
                raise NotImplementedError(
                    "extra bond features are not supported for stochastic "
                    "polymer bonds")
            self._add_bond_pair(a1, a2, f_bond, w12, w21)

    def _build_reaction(self, mol: tuple):
        mode = self.config.reaction_mode
        mol_reac: Molecule = mol[0]
        mol_prod: Molecule = mol[1]
        if mol_reac is None or mol_prod is None:
            raise ValueError("invalid reaction SMILES")
        ri2pi, pio, rio = map_reac_to_prod(mol_reac, mol_prod)

        balance = mode.endswith("_balance")
        if mode in ("reac_diff", "prod_diff", "reac_prod"):
            f_reac = [atom_features(mol_reac, a.idx) for a in mol_reac.atoms] + \
                     [atom_features_zeros(mol_prod, i) for i in pio]
            f_prod = [atom_features(mol_prod, ri2pi[a.idx])
                      if a.idx not in rio else atom_features_zeros(mol_reac, a.idx)
                      for a in mol_reac.atoms] + \
                     [atom_features(mol_prod, i) for i in pio]
        else:  # balance modes copy features across sides (reference :663-670)
            f_reac = [atom_features(mol_reac, a.idx) for a in mol_reac.atoms] + \
                     [atom_features(mol_prod, i) for i in pio]
            f_prod = [atom_features(mol_prod, ri2pi[a.idx])
                      if a.idx not in rio else atom_features(mol_reac, a.idx)
                      for a in mol_reac.atoms] + \
                     [atom_features(mol_prod, i) for i in pio]

        if mode in ("reac_diff", "prod_diff", "reac_diff_balance", "prod_diff_balance"):
            f_diff = [[y - x for x, y in zip(ii, jj)] for ii, jj in zip(f_reac, f_prod)]
        if mode in ("reac_prod", "reac_prod_balance"):
            self.f_atoms = [x + y[MAX_ATOMIC_NUM + 1:] for x, y in zip(f_reac, f_prod)]
        elif mode in ("reac_diff", "reac_diff_balance"):
            self.f_atoms = [x + y[MAX_ATOMIC_NUM + 1:] for x, y in zip(f_reac, f_diff)]
        elif mode in ("prod_diff", "prod_diff_balance"):
            self.f_atoms = [x + y[MAX_ATOMIC_NUM + 1:] for x, y in zip(f_prod, f_diff)]
        self.n_atoms = len(self.f_atoms)
        n_atoms_reac = mol_reac.n_atoms
        # unit weights: the reference leaves w_atoms/w_bonds unfilled in
        # reaction mode (featurization.py:642 TODO), which cannot feed its
        # weighted encoder; unit weights restore upstream-chemprop semantics.
        self.w_atoms = [1.0] * self.n_atoms

        rio_set = set(rio)
        for a1 in range(self.n_atoms):
            for a2 in range(a1 + 1, self.n_atoms):
                if a1 >= n_atoms_reac and a2 >= n_atoms_reac:
                    bond_prod = mol_prod.bond_between(pio[a1 - n_atoms_reac],
                                                      pio[a2 - n_atoms_reac])
                    bond_reac = bond_prod if balance else None
                elif a1 < n_atoms_reac and a2 >= n_atoms_reac:
                    bond_reac = None
                    if a1 in ri2pi:
                        bond_prod = mol_prod.bond_between(ri2pi[a1],
                                                          pio[a2 - n_atoms_reac])
                    else:
                        bond_prod = None
                else:
                    bond_reac = mol_reac.bond_between(a1, a2)
                    if a1 in ri2pi and a2 in ri2pi:
                        bond_prod = mol_prod.bond_between(ri2pi[a1], ri2pi[a2])
                    elif balance:
                        bond_prod = None if (a1 in ri2pi or a2 in ri2pi) else bond_reac
                    else:
                        bond_prod = None
                if bond_reac is None and bond_prod is None:
                    continue
                fr = bond_features(bond_reac)
                fp = bond_features(bond_prod)
                if mode in ("reac_diff", "prod_diff", "reac_diff_balance", "prod_diff_balance"):
                    fd = [y - x for x, y in zip(fr, fp)]
                if mode in ("reac_prod", "reac_prod_balance"):
                    f_bond = fr + fp
                elif mode in ("reac_diff", "reac_diff_balance"):
                    f_bond = fr + fd
                else:
                    f_bond = fp + fd
                self._add_bond_pair(a1, a2, f_bond)


def map_reac_to_prod(mol_reac: Molecule, mol_prod: Molecule):
    """Atom-map-number correspondence between reaction sides
    (reference featurization.py:253-283)."""
    only_prod_ids = []
    prod_map_to_id = {}
    mapnos_reac = {a.props.get("atom_map", 0) for a in mol_reac.atoms}
    for atom in mol_prod.atoms:
        mapno = atom.props.get("atom_map", 0)
        if mapno > 0:
            prod_map_to_id[mapno] = atom.idx
            if mapno not in mapnos_reac:
                only_prod_ids.append(atom.idx)
        else:
            only_prod_ids.append(atom.idx)
    only_reac_ids = []
    reac_id_to_prod_id = {}
    for atom in mol_reac.atoms:
        mapno = atom.props.get("atom_map", 0)
        if mapno > 0:
            if mapno in prod_map_to_id:
                reac_id_to_prod_id[atom.idx] = prod_map_to_id[mapno]
            else:
                only_reac_ids.append(atom.idx)
        else:
            only_reac_ids.append(atom.idx)
    return reac_id_to_prod_id, only_prod_ids, only_reac_ids
