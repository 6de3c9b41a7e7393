"""Parameter initialization of a MoleculeModel.

* :func:`init_model`: Xavier-normal weights and zero biases (reference
  nn_utils.py:102-112, applied model-wide by model.py:39), drawn from an
  explicit ``torch.Generator``.
* :func:`reference_init_model`: the reference-stream initialization of
  polymer_chemprop_tpu models/torch_init.py. The reference seeds torch once
  per fold, constructs the model (every ``nn.Linear`` consumes RNG in its
  constructor), then re-initializes every weight matrix with
  ``xavier_normal_`` in registration order. Replaying the two phases under
  ``torch.manual_seed(pytorch_seed)``, ``ensemble_index + 1`` times, gives
  that package's initial weights bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from .model import ModelConfig, MoleculeModel, ffn_dims


def init_model(model: MoleculeModel,
               generator: Optional[torch.Generator] = None) -> MoleculeModel:
    """Xavier-normal weights, zero biases, in place."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                nn.init.xavier_normal_(p, generator=generator)
            else:
                p.zero_()
    return model


def _skeleton_shapes(cfg: ModelConfig) -> List[Tuple[int, int, bool]]:
    """(in, out, has_bias) of every Linear in the reference's module
    construction order (mpn.py:46-64 per encoder, then model.py:79-100):
    also the registration order of :class:`MoleculeModel`. The reference
    builds the encoders even for a ``features_only`` model (a forward-time
    bypass, mpn.py:201-202), so their draws come first there too
    (polymer_chemprop_tpu models/torch_init.py:38-41)."""
    e = cfg.encoder
    shapes: List[Tuple[int, int, bool]] = []
    # atom_messages: W_i on the atom features, W_h on the messages and the
    # bond features (polymer_chemprop_tpu models/torch_init.py:45-46)
    input_dim = e.atom_fdim if e.atom_messages else e.bond_fdim
    w_h_input = e.hidden_size + (e.bond_fdim if e.atom_messages else 0)
    for _ in range(1 if cfg.mpn_shared else cfg.number_of_molecules):
        shapes.append((input_dim, e.hidden_size, e.bias))
        shapes.append((w_h_input, e.hidden_size, e.bias))
        shapes.append((e.atom_fdim + e.hidden_size, e.hidden_size, True))
        if e.atom_descriptors == "descriptor":
            d = e.hidden_size + e.atom_descriptors_size
            shapes.append((d, d, True))
    shapes += [(i, o, True) for i, o in ffn_dims(cfg)]
    return shapes


def reference_init_model(cfg: ModelConfig, pytorch_seed: int,
                         ensemble_index: int = 0) -> MoleculeModel:
    """A MoleculeModel (on the CPU) with the reference's initial weights
    for ensemble member ``ensemble_index``. The global torch RNG is left as
    it was found."""
    shapes = _skeleton_shapes(cfg)
    with torch.random.fork_rng(devices=[]):
        model = MoleculeModel(cfg)
        torch.manual_seed(pytorch_seed)
        for _ in range(ensemble_index + 1):
            layers = [nn.Linear(i, o, bias=b) for i, o, b in shapes]
            for layer in layers:
                nn.init.xavier_normal_(layer.weight)
    if cfg.features_only:
        # the port's model keeps only the FFN, the last layers drawn
        n_ffn = len(ffn_dims(cfg))
        shapes, layers = shapes[-n_ffn:], layers[-n_ffn:]
    linears = [m for m in model.modules() if isinstance(m, nn.Linear)]
    assert [tuple(l.weight.shape) for l in linears] == \
        [(o, i) for i, o, _ in shapes]
    with torch.no_grad():
        for dst, src in zip(linears, layers):
            dst.weight.copy_(src.weight)
            if dst.bias is not None:
                dst.bias.zero_()
    return model
