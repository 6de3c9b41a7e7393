"""Small NN building blocks: the activation registry.

Mirrors polymer_chemprop_tpu models/nn.py:19-27 and the fused kernel
epilogues of ops/pallas_mpnn.py:365-372 (reference nn_utils.py:70-99).
PReLU is LeakyReLU(0.25), its torch init value, not a learnable slope.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "relu": F.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "prelu": lambda x: F.leaky_relu(x, negative_slope=0.25),
    "tanh": torch.tanh,
    "selu": F.selu,
    "elu": F.elu,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    name = name.lower()
    if name not in _ACTIVATIONS:
        raise ValueError(f'Activation "{name}" not supported.')
    return _ACTIVATIONS[name]
