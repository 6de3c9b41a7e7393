"""2D molecular descriptors — the 200-descriptor ``rdkit_2d`` set.

The port's copy of polymer_chemprop_tpu chem/descriptors/ (the Python
engine behind ``rdkit_2d`` for Molecule inputs and for strings the C++
engine does not parse). Standalone reimplementation of the descriptor set the reference consumes
through descriptastorus (reference features_generators.py:92-133,
``RDKit2D`` / ``RDKit2DNormalized``).  Column names and order follow
descriptastorus's ``RDKIT_PROPS["1.0.0"]`` (verified empirically against
the vendored reference outputs in tests/data/regression.npz — see
tests/test_descriptors.py).

Submodules:

* :mod:`.estate`     — Kier–Hall electrotopological state indices
* :mod:`.counts`     — Lipinski/ring/valence counts, TPSA, rotatable bonds
* :mod:`.gasteiger`  — PEOE partial charges
* :mod:`.crippen`    — Wildman–Crippen logP / molar refractivity
* :mod:`.vsa`        — Labute approximate surface areas + the VSA bins
* :mod:`.topology`   — Chi/Kappa/BalabanJ/BertzCT/Ipc/HallKierAlpha
* :mod:`.fragments`  — the 85 ``fr_*`` fragment counts
* :mod:`.qed`        — quantitative estimate of drug-likeness
"""

from .rdkit2d import (  # noqa: F401
    RDKIT2D_NAMES,
    rdkit2d_raw,
    rdkit2d_raw_dict,
)
