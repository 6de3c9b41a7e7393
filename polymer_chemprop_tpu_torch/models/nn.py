"""Small NN building blocks: activations, linear, dropout, parameter norms.

Mirrors polymer_chemprop_tpu models/nn.py and the fused kernel epilogues of
ops/pallas_mpnn.py:365-372 (reference nn_utils.py:11-30, 70-99). PReLU is
LeakyReLU(0.25), its torch init value, not a learnable slope.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

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


def linear(layer: torch.nn.Linear, x: torch.Tensor,
           bf16: bool = False) -> torch.Tensor:
    """Dense layer ``x @ W^T + b``: :func:`dense` with the layer's weight
    and bias."""
    return dense(x, layer.weight, layer.bias, bf16)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          bf16: bool = False) -> torch.Tensor:
    """``x @ weight^T + bias`` for a weight in torch's (out, in) layout (or
    a column slice of one). With ``bf16`` it has the meaning of the JAX
    package's mixed-precision ``linear`` (models/nn.py:52-65): input and
    weight are rounded to bfloat16, the product is accumulated and returned
    in float32, and the bias is added in float32. Parameters stay float32.

    The rounded operands are multiplied as float32 tensors, which gives
    that meaning on both devices (a product of two bfloat16 tensors would
    round its result to bfloat16 as well). Autograd through the two casts
    rounds the operands' gradients to bfloat16, as jax.grad does."""
    if not bf16:
        return F.linear(x, weight, bias)
    y = x.to(torch.bfloat16).float() @ weight.to(torch.bfloat16).float().t()
    return y if bias is None else y + bias


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout; the identity at rate 0 or outside training. The
    mask is drawn from ``generator``, which must live on ``x``'s device
    (``None`` draws from that device's global stream)."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def param_count(params: Iterable[torch.Tensor]) -> int:
    return sum(p.numel() for p in params)


def compute_pnorm(params: Iterable[torch.Tensor]) -> float:
    """Parameter L2 norm (reference nn_utils.py:11-19)."""
    return float(torch.sqrt(sum((p.detach() ** 2).sum() for p in params)))
