"""Bemis–Murcko scaffolds and graph-invariant scaffold keys.

Replaces RDKit's ``MurckoScaffold.MurckoScaffoldSmiles`` used for scaffold
splits (reference data/scaffold.py:15-29). Scaffold extraction keeps ring
atoms, linker atoms, and atoms multiple-bonded to the framework (standard
Bemis–Murcko definition). Equality keys are Weisfeiler–Lehman graph hashes
instead of canonical SMILES: two scaffolds group together iff their colored
graphs agree, which is what the splitter needs.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Set

from .mol import AROMATIC, Molecule, SINGLE
from .smiles import parse_smiles


def murcko_scaffold_atoms(mol: Molecule) -> Set[int]:
    """Indices of the scaffold: rings + linkers, plus atoms multiple-bonded
    directly to that framework (RDKit MurckoScaffold semantics: cyclohexanone
    keeps its =O, acetophenone's whole acetyl side chain is removed)."""
    # 1. iteratively prune all terminal atoms -> rings + linker paths remain
    alive = {a.idx for a in mol.atoms}
    changed = True
    while changed:
        changed = False
        for a in list(alive):
            if mol.atoms[a].in_ring:
                continue
            deg = sum(1 for b in mol.atom_bonds(a) if b.other(a) in alive)
            if deg <= 1:
                alive.discard(a)
                changed = True
    # 2. add back substituents attached to the framework by multiple bonds
    extra = set()
    for a in alive:
        for b in mol.atom_bonds(a):
            o = b.other(a)
            if o not in alive and b.kekule_order != SINGLE and b.order != AROMATIC:
                extra.add(o)
    return alive | extra


def _wl_hash(mol: Molecule, atoms: Set[int], iterations: int = 4,
             include_chirality: bool = False) -> str:
    """Weisfeiler–Lehman hash of the induced subgraph."""
    if not atoms:
        return ""
    idx = sorted(atoms)
    colors = {}
    for a in idx:
        at = mol.atoms[a]
        label = (at.atomic_num, at.formal_charge, at.is_aromatic)
        if include_chirality:
            label = label + (at.chiral_tag,)
        colors[a] = hashlib.sha1(str(label).encode()).hexdigest()[:16]
    for _ in range(iterations):
        new = {}
        for a in idx:
            nbr_labels = []
            for b in mol.atom_bonds(a):
                o = b.other(a)
                if o in atoms:
                    order = "ar" if (b.order == AROMATIC or b.is_aromatic) \
                        else str(b.order)
                    nbr_labels.append(order + ":" + colors[o])
            sig = colors[a] + "|" + ",".join(sorted(nbr_labels))
            new[a] = hashlib.sha1(sig.encode()).hexdigest()[:16]
        colors = new
    return hashlib.sha1(",".join(sorted(colors.values())).encode()).hexdigest()


def scaffold_key(smiles_or_mol, include_chirality: bool = False) -> str:
    """Scaffold equivalence key of a molecule (reference
    data/scaffold.py:15-29 returns a canonical scaffold SMILES; a WL graph
    hash provides the same grouping)."""
    mol: Optional[Molecule]
    if isinstance(smiles_or_mol, str):
        s = smiles_or_mol
        if ">" in s:
            # reaction SMILES: scaffold of the REACTANT side only
            # (reference data/scaffold.py:25-26 takes mol[0] of the tuple)
            s = s.split(">")[0]
        elif "|" in s:
            # polymer ensemble string: scaffold of the monomer SMILES
            s = s.split("|")[0]
        mol = parse_smiles(s, strict=False)
    else:
        mol = smiles_or_mol
    if mol is None:
        return "<invalid>"
    atoms = murcko_scaffold_atoms(mol)
    return _wl_hash(mol, atoms, include_chirality=include_chirality)
