"""Parameter conversion between the JAX package's pytree and MoleculeModel.

The JAX package stores each Linear as ``{"w": (in, out), "b": (out,)}`` and
computes ``y = x @ w + b`` (polymer_chemprop_tpu models/nn.py:52-64);
``nn.Linear`` holds ``weight`` as ``(out, in)``. So ``weight = w.T``: the
one transpose, in each direction, lives here.

JAX pytree layout: ``{"encoders": [{"W_i": {...}, "W_h": {...},
"W_o": {...}}, ...], "ffn": [{...}, ...]}``, each encoder with a ``"W_d"``
as well in the ``"descriptor"`` mode. With ``mpn_shared`` the JAX list
repeats one encoder, and the port keeps one module. The JAX package's
optimizer then updates each copy with its own position's gradient, so a
file it trained can hold copies that differ: a shared model refuses such a
file (:func:`encoder_copies_differ`), and serving builds one encoder per
position instead (train/make_predictions.py ``serving_model``). A
``features_only`` model has no ``"encoders"`` entry (JAX model.py:67).

The optimizer state crosses the same way. The JAX package saves its optax
state as the flat list of leaves (utils/checkpoint.py:94-99), and jax
flattens dicts in sorted key order and skips empty nodes, so for the
chains that train/scheduler.py builds the list is

* adam, adamw: ``[count, *mu, *nu, count]`` (scale_by_adam's count and
  moments, then scale_by_schedule's count), each moment tree holding the
  trainable parameters only (frozen ones are masked out by
  ``multi_transform``) in the order ``encoders[i].{W_d, W_h, W_i,
  W_o}.{b, w}``, ``ffn[j].{b, w}``;
* sgd: ``[count]``.

``clip_by_global_norm``, ``add_decayed_weights`` and ``set_to_zero`` carry
no leaves.

The SSL pretraining model (ssl.py) has its own tree (JAX ssl.py:103-114):
``{"encoder": {W_i, W_h, W_o}, "node_head": {...}, "edge_head": {...},
"graph_head": [{...}, {...}]}``; :func:`ssl_params_from_jax` and
:func:`ssl_params_to_jax` carry it the same way. :func:`opt_state_to_leaves` and :func:`opt_state_from_leaves`
map that list to and from a ``torch.optim`` optimizer's state.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .model import MoleculeModel

_ENCODER_LINEARS = ("W_i", "W_h", "W_o", "W_d")


def _linear_state(prefix: str, p: Dict) -> Dict[str, torch.Tensor]:
    w = np.asarray(p["w"], dtype=np.float32)
    state = {f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(w.T))}
    if "b" in p:
        state[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(p["b"], dtype=np.float32).copy())
    return state


def encoder_copies_differ(params: Dict) -> Optional[str]:
    """None when every molecule position's encoder equals the first one,
    leaf for leaf and bit for bit; else the first parameter that differs,
    with its largest absolute difference."""
    encoders = params.get("encoders", [])
    for i, enc in enumerate(encoders[1:], 1):
        for name in sorted(set(encoders[0]) | set(enc)):
            first, other = encoders[0].get(name, {}), enc.get(name, {})
            for leaf in sorted(set(first) | set(other)):
                where = f"encoders[{i}].{name}.{leaf}"
                if leaf not in first or leaf not in other:
                    return f"{where} is missing from one of the copies"
                a, b = np.asarray(first[leaf]), np.asarray(other[leaf])
                if a.shape != b.shape:
                    return (f"{where} has shape {b.shape}, encoders[0]'s "
                            f"has {a.shape}")
                if not np.array_equal(a, b):
                    diff = np.max(np.abs(a.astype(np.float64) - b))
                    return (f"{where} differs from encoders[0].{name}.{leaf}"
                            f" by up to {diff:.6g}")
    return None


def check_shared_copies(params: Dict) -> None:
    """Raise a ValueError, naming the parameter, when the encoder copies
    of ``params`` differ: a model with ``mpn_shared`` holds one encoder
    for every molecule position, so it cannot take them."""
    differ = encoder_copies_differ(params)
    if differ:
        raise ValueError(
            f"{differ}: a model with mpn_shared holds one encoder for every "
            "molecule position, so it cannot take these copies (serving "
            "builds one encoder per position; training on from such a file "
            "is not supported)")


def params_from_jax(params: Dict, mpn_shared: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy leaves) -> MoleculeModel state dict.
    With ``mpn_shared`` the one encoder is copy 0, once
    :func:`check_shared_copies` has found the copies equal."""
    state: Dict[str, torch.Tensor] = {}
    encoders = params.get("encoders", [])
    if mpn_shared:
        check_shared_copies(params)
        encoders = encoders[:1]
    for i, enc in enumerate(encoders):
        extra = set(enc) - set(_ENCODER_LINEARS)
        if extra:
            raise ValueError(f"unknown encoder parameters {sorted(extra)}")
        for name in _ENCODER_LINEARS:
            if name in enc:
                state.update(_linear_state(f"encoders.{i}.{name}",
                                           enc[name]))
    for j, layer in enumerate(params["ffn"]):
        state.update(_linear_state(f"ffn.{j}", layer))
    return state


def _param_tree(model: MoleculeModel, leaf: Callable) -> Dict:
    """A pytree in the JAX parameter layout with ``leaf(p)`` at each model
    parameter ``p``. A shared encoder is repeated per molecule position."""
    def linear(mod: torch.nn.Linear) -> Dict:
        p = {"w": leaf(mod.weight)}
        if mod.bias is not None:
            p["b"] = leaf(mod.bias)
        return p

    tree = {"ffn": [linear(l) for l in model.ffn]}
    if model.cfg.features_only:
        return tree
    encs = [{name: linear(getattr(e, name)) for name in _ENCODER_LINEARS
             if hasattr(e, name)} for e in model.encoders]
    if model.cfg.mpn_shared:
        encs = encs * model.cfg.number_of_molecules
    tree["encoders"] = encs
    return tree


def _to_jax_layout(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.T.copy() if a.ndim == 2 else a.copy()


def params_to_jax(model: MoleculeModel) -> Dict:
    """MoleculeModel -> JAX parameter pytree (numpy leaves), the inverse of
    :func:`params_from_jax`."""
    return _param_tree(model, _to_jax_layout)


def load_jax_params(model: MoleculeModel, params: Dict) -> MoleculeModel:
    """Copy a JAX parameter pytree into ``model`` (strict: every tensor of
    the model must be given, and nothing else)."""
    model.load_state_dict(params_from_jax(params, model.cfg.mpn_shared),
                          strict=True)
    return model


_SSL_HEADS = ("node_head", "edge_head")


def ssl_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX SSL parameter tree (numpy leaves) -> SSLModel state dict."""
    state: Dict[str, torch.Tensor] = {}
    for name in _ENCODER_LINEARS:
        if name in params["encoder"]:
            state.update(_linear_state(f"encoder.{name}",
                                       params["encoder"][name]))
    for name in _SSL_HEADS:
        state.update(_linear_state(name, params[name]))
    for j, layer in enumerate(params["graph_head"]):
        state.update(_linear_state(f"graph_head.{j}", layer))
    return state


def ssl_params_to_jax(model) -> Dict:
    """SSLModel -> JAX SSL parameter tree (numpy leaves), the inverse of
    :func:`ssl_params_from_jax`."""
    def linear(mod: torch.nn.Linear) -> Dict:
        p = {"w": _to_jax_layout(mod.weight)}
        if mod.bias is not None:
            p["b"] = _to_jax_layout(mod.bias)
        return p

    tree = {"encoder": {name: linear(getattr(model.encoder, name))
                        for name in _ENCODER_LINEARS
                        if hasattr(model.encoder, name)},
            "graph_head": [linear(l) for l in model.graph_head]}
    for name in _SSL_HEADS:
        tree[name] = linear(getattr(model, name))
    return tree


def _sorted_leaves(tree) -> List:
    """Leaves in jax's flattening order: dict keys sorted, lists in order,
    None skipped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [] if tree is None else [tree]


def _trainable_in_jax_order(model: MoleculeModel, optimizer
                            ) -> List[torch.nn.Parameter]:
    """The optimizer's parameters in the JAX state's leaf order. A shared
    encoder appears once per molecule position, as in the JAX pytree."""
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    return _sorted_leaves(
        _param_tree(model, lambda p: p if id(p) in owned else None))


def _is_adam(optimizer) -> bool:
    return isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW))


def opt_state_to_leaves(model: MoleculeModel,
                        optimizer: torch.optim.Optimizer,
                        count: int) -> List[np.ndarray]:
    """The optimizer's state after ``count`` updates as the JAX package's
    list of optax leaves (see the module docstring)."""
    c = np.asarray(count, np.int32)
    if not _is_adam(optimizer):
        return [c]
    params = _trainable_in_jax_order(model, optimizer)

    def moments(key):
        out = []
        for p in params:
            st = optimizer.state.get(p)
            out.append(_to_jax_layout(st[key] if st else torch.zeros_like(p)))
        return out

    return [c, *moments("exp_avg"), *moments("exp_avg_sq"), c]


def opt_state_from_leaves(model: MoleculeModel,
                          optimizer: torch.optim.Optimizer,
                          leaves: List[np.ndarray]) -> int:
    """Load a list of optax leaves into ``optimizer`` (moments transposed
    back to ``(out, in)``); returns the update count."""
    count = int(np.asarray(leaves[0]))
    if not _is_adam(optimizer):
        return count
    params = _trainable_in_jax_order(model, optimizer)
    n = len(params)
    if len(leaves) != 2 * n + 2:
        raise ValueError(f"optimizer state has {len(leaves)} leaves, "
                         f"expected {2 * n + 2} for {n} trainable parameters")
    for i, p in enumerate(params):
        def moment(a):
            a = np.asarray(a, np.float32)
            t = torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2
                                                      else a))
            return t.to(p.device).reshape(p.shape).clone()
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": moment(leaves[1 + i]),
            "exp_avg_sq": moment(leaves[1 + n + i]),
        }
    return count
