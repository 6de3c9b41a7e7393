"""Shared hybridization refinements used across descriptor modules."""

from __future__ import annotations

from ..mol import Molecule


def conjugated_lone_pair_sp2(mol: Molecule, idx: int) -> bool:
    """RDKit's hybridization model marks SP3-perceived N/O with a
    conjugating lone pair (amide/aniline N, ester/phenol O) as SP2.
    Shared by the Gasteiger charge model and the Hall-Kier alpha table
    (and mirrored in native/src/pcp_descriptors.inc — keep in sync)."""
    a = mol.atoms[idx]
    return (a.atomic_num in (7, 8)
            and any(b.conjugated for b in mol.atom_bonds(idx)))
