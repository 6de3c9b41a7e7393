"""The reference's featurizer: a frozen copy of the port's pure-Python
featurization (``features/featurization.py`` and its ``chem/`` modules)."""

from .config import FeaturizationConfig
from .featurization import MolGraph

__all__ = ["FeaturizationConfig", "MolGraph"]
