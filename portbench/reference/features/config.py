# Frozen copy of polymer_chemprop_tpu_torch/features/config.py, the benchmark reference's
# own featurizer: later changes to the port do not reach it.
"""Explicit featurization configuration.

The reference controls featurization through a module-level mutable singleton
(``PARAMS`` + ``set_polymer``/``set_reaction``/... setters, reference
featurization.py:53-171) that the trainer mutates once per run
(cross_validate.py:64-69). This framework threads an immutable config
object through the featurizer instead, so no global state is shared.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

MAX_ATOMIC_NUM = 100

# Feature vocabularies — identical content to reference featurization.py:20-43.
ATOM_FEATURES = {
    "atomic_num": list(range(MAX_ATOMIC_NUM)),
    "degree": [0, 1, 2, 3, 4, 5],
    "formal_charge": [-1, -2, 1, 2, 0],
    "chiral_tag": [0, 1, 2, 3],
    "num_Hs": [0, 1, 2, 3, 4],
    "hybridization": ["SP", "SP2", "SP3", "SP3D", "SP3D2"],
}

# len(choices)+1 per one-hot (unknown slot) + aromatic flag + scaled mass
ATOM_FDIM = sum(len(c) + 1 for c in ATOM_FEATURES.values()) + 2  # = 133
BOND_FDIM = 14

REACTION_MODES = (
    "reac_prod", "reac_diff", "prod_diff",
    "reac_prod_balance", "reac_diff_balance", "prod_diff_balance",
)


@dataclasses.dataclass(frozen=True)
class FeaturizationConfig:
    """Immutable featurization settings (replaces reference PARAMS singleton)."""

    polymer: bool = False
    reaction: bool = False
    reaction_mode: Optional[str] = None
    explicit_h: bool = False   # keep explicit Hs from input (reference EXPLICIT_H)
    adding_h: bool = False     # add all Hs as graph atoms (reference ADDING_H)
    extra_atom_fdim: int = 0
    extra_bond_fdim: int = 0
    overwrite_default_atom_features: bool = False
    overwrite_default_bond_features: bool = False

    def __post_init__(self):
        if self.reaction and self.reaction_mode not in REACTION_MODES:
            raise ValueError(f"reaction mode must be one of {REACTION_MODES}")
        if self.reaction and self.polymer:
            raise ValueError("reaction and polymer modes are mutually exclusive")

    @classmethod
    def for_reaction(cls, mode: str, **kw) -> "FeaturizationConfig":
        """Reaction featurization doubles most feature channels
        (reference set_reaction, featurization.py:114-118)."""
        return cls(reaction=True, reaction_mode=mode,
                   extra_atom_fdim=ATOM_FDIM - MAX_ATOMIC_NUM - 1,
                   extra_bond_fdim=BOND_FDIM, **kw)

    @property
    def atom_fdim(self) -> int:
        """reference get_atom_fdim (featurization.py:70-77)."""
        base = 0 if self.overwrite_default_atom_features else ATOM_FDIM
        return base + self.extra_atom_fdim

    def bond_fdim(self, atom_messages: bool = False) -> int:
        """reference get_bond_fdim (featurization.py:151-166)."""
        base = 0 if self.overwrite_default_bond_features else BOND_FDIM
        return base + self.extra_bond_fdim + \
            (0 if atom_messages else self.atom_fdim)

    def replace(self, **kw) -> "FeaturizationConfig":
        return dataclasses.replace(self, **kw)
