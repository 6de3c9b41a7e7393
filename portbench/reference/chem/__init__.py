# Frozen copy of polymer_chemprop_tpu_torch/chem/__init__.py, the benchmark reference's
# own featurizer: later changes to the port do not reach it.
"""Standalone chemistry runtime (no RDKit dependency).

Replaces the reference's RDKit layer (L0 in SURVEY.md §1): SMILES parsing,
molecule perception, Morgan fingerprints, and Murcko scaffolds.
"""

from .mol import (
    AROMATIC,
    Atom,
    Bond,
    DOUBLE,
    KekulizationError,
    Molecule,
    SINGLE,
    TRIPLE,
)
from .smiles import SmilesParseError, parse_smiles

__all__ = [
    "AROMATIC",
    "Atom",
    "Bond",
    "DOUBLE",
    "KekulizationError",
    "Molecule",
    "SINGLE",
    "SmilesParseError",
    "TRIPLE",
    "parse_smiles",
]
