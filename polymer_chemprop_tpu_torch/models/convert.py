"""Parameter conversion between the JAX package's pytree and MoleculeModel.

The JAX package stores each Linear as ``{"w": (in, out), "b": (out,)}`` and
computes ``y = x @ w + b`` (polymer_chemprop_tpu models/nn.py:52-64);
``nn.Linear`` holds ``weight`` as ``(out, in)``. So ``weight = w.T``: the
one transpose, in each direction, lives here.

JAX pytree layout: ``{"encoders": [{"W_i": {...}, "W_h": {...},
"W_o": {...}}, ...], "ffn": [{...}, ...]}``. With ``mpn_shared`` the JAX
list repeats one encoder; the port keeps one module.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .model import MoleculeModel

_ENCODER_LINEARS = ("W_i", "W_h", "W_o")


def _linear_state(prefix: str, p: Dict) -> Dict[str, torch.Tensor]:
    w = np.asarray(p["w"], dtype=np.float32)
    state = {f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(w.T))}
    if "b" in p:
        state[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(p["b"], dtype=np.float32).copy())
    return state


def params_from_jax(params: Dict, mpn_shared: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy leaves) -> MoleculeModel state dict."""
    state: Dict[str, torch.Tensor] = {}
    encoders = params.get("encoders", [])
    if mpn_shared:
        encoders = encoders[:1]
    for i, enc in enumerate(encoders):
        extra = set(enc) - set(_ENCODER_LINEARS)
        if extra:
            raise NotImplementedError(
                f"encoder parameters {sorted(extra)} are not on the port yet")
        for name in _ENCODER_LINEARS:
            state.update(_linear_state(f"encoders.{i}.{name}", enc[name]))
    for j, layer in enumerate(params["ffn"]):
        state.update(_linear_state(f"ffn.{j}", layer))
    return state


def params_to_jax(model: MoleculeModel) -> Dict:
    """MoleculeModel -> JAX parameter pytree (numpy leaves), the inverse of
    :func:`params_from_jax`."""
    def linear(mod: torch.nn.Linear) -> Dict[str, np.ndarray]:
        p = {"w": mod.weight.detach().cpu().numpy().T.copy()}
        if mod.bias is not None:
            p["b"] = mod.bias.detach().cpu().numpy().copy()
        return p

    encs = [{name: linear(getattr(e, name)) for name in _ENCODER_LINEARS}
            for e in model.encoders]
    if model.cfg.mpn_shared:
        encs = encs * model.cfg.number_of_molecules
    return {"encoders": encs, "ffn": [linear(l) for l in model.ffn]}


def load_jax_params(model: MoleculeModel, params: Dict) -> MoleculeModel:
    """Copy a JAX parameter pytree into ``model`` (strict: every tensor of
    the model must be given, and nothing else)."""
    model.load_state_dict(params_from_jax(params, model.cfg.mpn_shared),
                          strict=True)
    return model
