"""Interop with reference (torch-pickle) checkpoints.

The port's copy of polymer_chemprop_tpu utils/torch_import.py. It returns
parameters in the JAX package's layout (numpy, Linear ``w`` as ``(in,
out)``), which models/convert.py carries into the port's modules.

Users of the reference framework carry trained ``.pt`` files in one of
three shapes:

* *inference checkpoint* — ``{'args': dict, 'state_dict', 'data_scaler',
  'features_scaler', 'atom_descriptor_scaler', 'bond_feature_scaler'}``
  (reference utils.py:47-73, written as ``initial_model.pt`` /
  ``best_model_full.pt``);
* *weights-only checkpoint* — ``{'state_dict': ...}`` without args
  (reference utils.py:94-95, SSL outputs consumed via --checkpoint_frzn);
* *SSL script checkpoint* — ``{'model_state_dict': ...}`` with the SSL
  model's own parameter names ``W_initial/W_message/W_node``
  (reference ssl_two_stage_V5_C.py:1031-1035, 155-161).

``import_reference_checkpoint`` converts any of them into the
``(params, config_dict, scalers, epoch)`` tuple of utils/checkpoint.py;
``utils.checkpoint.load_checkpoint`` dispatches here automatically for
non-native files, so every consumer (predict, fingerprint, warm-start,
--checkpoint_frzn, resume) accepts reference ``.pt`` checkpoints
transparently. ``export_reference_checkpoint`` writes the reverse
direction so weights trained here can be cross-checked in the reference.

torch ``nn.Linear`` stores weights as (out, in); the checkpoint layout is
(in, out) — weights are transposed in both directions. Reference
state-dict naming (mpn.py:48-64, model.py:79-113; legacy
``encoder.encoder.W_*`` names are renamed to index 0 exactly as reference
utils.py:109-113 does):

* ``encoder.encoder.{i}.W_i|W_h|W_o.weight|bias`` -> encoders[i]
* ``encoder.encoder.{i}.atom_descriptors_layer.*``-> encoders[i]["W_d"]
* ``ffn.{3k+1}.weight|bias``                      -> ffn[k]
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

# maps the SSL scripts' parameter names onto the encoder's
# (ssl_two_stage_V5_C.py:155-161 vs mpn.py:48-58: same roles, same shapes
# modulo the SSL script's own featurization dims)
_SSL_NAME_MAP = {"W_initial": "W_i", "W_message": "W_h", "W_node": "W_o"}

_ENC_RE = re.compile(
    r"^encoder\.encoder\.(?:(\d+)\.)?"
    r"(W_i|W_h|W_o|atom_descriptors_layer)\.(weight|bias)$")
_FFN_RE = re.compile(r"^ffn\.(\d+)\.(weight|bias)$")
_SSL_RE = re.compile(r"^(?:.*\.)?(W_initial|W_message|W_node)\.(weight|bias)$")


def _to_np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def state_dict_to_params(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a reference torch state_dict into this framework's
    parameter pytree ``{"encoders": [...], "ffn": [...]}``.

    Unrecognized keys (cached_zero_vector, SSL prediction heads, ...) are
    skipped, mirroring the reference's tolerant partial load
    (utils.py:116-130)."""
    encoders: Dict[int, Dict[str, Dict[str, np.ndarray]]] = {}
    ffn: Dict[int, Dict[str, np.ndarray]] = {}

    def put(slot: Dict[str, np.ndarray], kind: str, value) -> None:
        arr = _to_np(value)
        if kind == "weight":
            slot["w"] = arr.T.copy()
        else:
            slot["b"] = arr

    for key, value in sd.items():
        m = _ENC_RE.match(key)
        if m:
            idx = int(m.group(1)) if m.group(1) is not None else 0
            name = "W_d" if m.group(2) == "atom_descriptors_layer" \
                else m.group(2)
            put(encoders.setdefault(idx, {}).setdefault(name, {}),
                m.group(3), value)
            continue
        m = _FFN_RE.match(key)
        if m:
            put(ffn.setdefault(int(m.group(1)), {}), m.group(2), value)
            continue
        m = _SSL_RE.match(key)
        if m:
            put(encoders.setdefault(0, {}).setdefault(
                _SSL_NAME_MAP[m.group(1)], {}), m.group(2), value)
    params: Dict[str, Any] = {}
    if encoders:
        params["encoders"] = [encoders[i] for i in sorted(encoders)]
    if ffn:
        params["ffn"] = [ffn[i] for i in sorted(ffn)]
    return params


def _params_to_state_dict(params: Dict[str, Any]) -> Dict[str, Any]:
    """The reverse mapping (reference naming, torch tensors)."""
    import torch
    sd: Dict[str, Any] = {}

    def put(name, arr, transpose):
        a = np.asarray(arr, np.float32)
        sd[name] = torch.tensor(a.T.copy() if transpose else a)

    for i, enc in enumerate(params.get("encoders", [])):
        prefix = f"encoder.encoder.{i}."
        for name, sub in enc.items():
            ref_name = "atom_descriptors_layer" if name == "W_d" else name
            if "w" in sub:
                put(prefix + ref_name + ".weight", sub["w"], True)
            if "b" in sub:
                put(prefix + ref_name + ".bias", sub["b"], False)
    for k, layer in enumerate(params.get("ffn", [])):
        # reference FFN Sequential: dropout(0), Linear(1), then
        # [act, dropout, Linear] repeats -> linear indices 3k+1
        # (model.py:79-100)
        idx = 3 * k + 1
        if "w" in layer:
            put(f"ffn.{idx}.weight", layer["w"], True)
        if "b" in layer:
            put(f"ffn.{idx}.bias", layer["b"], False)
    return sd


def import_reference_checkpoint(path: str) -> Tuple[
        Dict[str, Any], Optional[dict], Dict[str, Optional[dict]],
        Optional[int]]:
    """Load a reference ``.pt`` checkpoint (any of the three shapes).

    Returns ``(params, config_dict, scaler_dicts, epoch)``; config and
    scalers are None/empty for weights-only checkpoints. Scaler dicts use
    the reference's ``{'means': [...], 'stds': [...]}`` layout, which is
    also this framework's (data/scaler.py)."""
    import torch
    state = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(state, dict):
        raise ValueError(f"{path} is not a recognizable checkpoint "
                         "(expected a dict)")
    sd = state.get("state_dict", state.get("model_state_dict"))
    if sd is None:
        raise ValueError(f"{path} has neither 'state_dict' nor "
                         "'model_state_dict'")
    params = state_dict_to_params(sd)
    if not params:
        raise ValueError(f"{path}: no recognizable encoder/ffn parameters "
                         "in its state dict")
    config_dict = None
    if "args" in state:
        args = state["args"]
        config_dict = dict(vars(args)) if not isinstance(args, dict) \
            else dict(args)
        # reference checkpoints carry the resolved task names
        # (cross_validate.py:45); expose them as target_columns so
        # prediction-time task counting needs no access to the original
        # training CSV. Some tap versions omit the task_names property from
        # as_dict() — fall back to the task count implied by the FFN output
        # shape (numbered names) rather than silently predicting one task.
        tasks = config_dict.get("task_names") or config_dict.get(
            "_task_names")
        if not tasks and params.get("ffn"):
            out = int(params["ffn"][-1]["w"].shape[1])
            if config_dict.get("dataset_type") == "multiclass":
                out //= int(config_dict.get("multiclass_num_classes", 3))
            tasks = [f"task_{i}" for i in range(out)]
        if tasks and not config_dict.get("target_columns"):
            config_dict["target_columns"] = list(tasks)
    scalers = {k: state.get(k) for k in
               ("data_scaler", "features_scaler", "atom_descriptor_scaler",
                "bond_feature_scaler") if state.get(k) is not None}
    epoch = state.get("epoch")
    return params, config_dict, scalers, epoch


def export_reference_checkpoint(path: str, params, config_dict: dict,
                                scalers: Optional[dict] = None) -> None:
    """Write this framework's parameters as a reference-format ``.pt``
    inference checkpoint (utils.py:47-73 layout) so they can be loaded by
    the reference's ``load_checkpoint`` for cross-framework verification."""
    import torch
    state = {
        "args": dict(config_dict),
        "state_dict": _params_to_state_dict(params),
    }
    for key in ("data_scaler", "features_scaler", "atom_descriptor_scaler",
                "bond_feature_scaler"):
        sc = (scalers or {}).get(key)
        if sc is not None and hasattr(sc, "to_dict"):
            sc = sc.to_dict()
        state[key] = sc
    torch.save(state, path)
