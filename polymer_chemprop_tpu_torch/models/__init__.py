"""Model layer: activations, the bond-message encoder and MoleculeModel."""
