"""Featurization layer: molecule -> static-shape graph arrays."""

from .config import (
    ATOM_FDIM,
    BOND_FDIM,
    MAX_ATOMIC_NUM,
    FeaturizationConfig,
)
from .featurization import (
    MolGraph,
    atom_features,
    atom_features_zeros,
    bond_features,
    make_mol,
    make_polymer_mol,
    onek_encoding_unk,
    parse_polymer_rules,
    remove_wildcard_atoms,
    tag_atoms_in_repeating_unit,
)
from .batching import GraphBatch, batch_graphs, mol2graph, round_up

__all__ = [
    "ATOM_FDIM", "BOND_FDIM", "MAX_ATOMIC_NUM", "FeaturizationConfig",
    "MolGraph", "atom_features", "atom_features_zeros", "bond_features",
    "make_mol", "make_polymer_mol", "onek_encoding_unk", "parse_polymer_rules",
    "remove_wildcard_atoms", "tag_atoms_in_repeating_unit",
    "GraphBatch", "batch_graphs", "mol2graph", "round_up",
]
