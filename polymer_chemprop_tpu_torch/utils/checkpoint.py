"""Read and write the JAX package's ``.ckpt`` checkpoint format.

The port's copy of polymer_chemprop_tpu utils/checkpoint.py, with numpy
and zipfile only. A ``.ckpt`` is a zip of ``meta.json`` (train config,
scalers, epoch), ``params.npz`` (the flattened parameter pytree: ``a/b``
for dict levels, ``0#`` for list items, ``@none`` for None leaves) and,
for a resume checkpoint, ``opt.npz``: the optimizer state as the list of
leaves ``"0", "1", ...`` in the order the JAX package flattens its optax
state. Parameters and moments stay in the JAX layout here (Linear ``w``
is ``(in, out)``); models/convert.py maps both onto the torch side.

Every file without ``meta.json`` (each shape of reference torch ``.pt``
checkpoint) goes through utils/torch_import.py, so every consumer
(serving, fingerprints, warm start, ``checkpoint_frzn``, resume) reads
reference checkpoints as the JAX package does.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data.scaler import StandardScaler


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}#/"))
    elif tree is None:
        out[prefix + "@none"] = np.zeros(0)
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    """Rebuild the pytree from path-keyed arrays ('#' marks list levels)."""
    if list(flat.keys()) == [""]:
        return flat[""]
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        if key.endswith("@none"):
            parts = key.split("/")[:-1]
            node = root
            for p in parts[:-1] if parts else []:
                node = node.setdefault(p, {})
            continue
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.endswith("#") for k in keys):
            idx = sorted(keys, key=lambda k: int(k[:-1]))
            return [listify(node[k]) for k in idx]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_checkpoint(path: str, params, config_dict: dict,
                    scalers: Optional[Dict[str, Optional[StandardScaler]]] = None,
                    epoch: Optional[int] = None,
                    opt_leaves: Optional[List[np.ndarray]] = None,
                    extra_meta: Optional[dict] = None) -> None:
    """Write a ``.ckpt`` (zip of params.npz + meta.json [+ opt.npz]) from
    a pytree of numpy arrays in the JAX layout. ``extra_meta`` adds keys
    to ``meta.json`` (the SSL export's ``ssl`` and
    ``transfer_strategy``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {
        "config": config_dict,
        "epoch": epoch,
        "scalers": {k: (v.to_dict() if v is not None else None)
                    for k, v in (scalers or {}).items()},
    }
    if extra_meta:
        meta.update(extra_meta)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("meta.json", json.dumps(meta))
        buf = io.BytesIO()
        np.savez(buf, **_flatten(params))
        zf.writestr("params.npz", buf.getvalue())
        if opt_leaves is not None:
            buf = io.BytesIO()
            np.savez(buf, **{str(i): np.asarray(leaf)
                             for i, leaf in enumerate(opt_leaves)})
            zf.writestr("opt.npz", buf.getvalue())
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Any, Optional[dict],
                                        Dict[str, Optional[StandardScaler]],
                                        Optional[int]]:
    """Read params (numpy pytree), config dict, scalers and epoch. A file
    without ``meta.json`` is a reference ``.pt`` (config None for a
    weights-only one); a corrupt native ``.ckpt`` raises."""
    try:
        zf = zipfile.ZipFile(path)
    except zipfile.BadZipFile:
        zf = None  # a legacy torch pickle (before torch 1.6)
    if zf is None or "meta.json" not in zf.namelist():
        # torch >= 1.6 writes .pt files as zips too (data.pkl entries)
        if zf is not None:
            zf.close()
        from .torch_import import import_reference_checkpoint
        params, config, scaler_dicts, epoch = \
            import_reference_checkpoint(path)
        scalers = {k: StandardScaler.from_dict(v)
                   for k, v in scaler_dicts.items()}
        return params, config, scalers, epoch
    with zf:
        meta = json.loads(zf.read("meta.json"))
        npz = np.load(io.BytesIO(zf.read("params.npz")))
        params = _unflatten({k: npz[k] for k in npz.files})
    scalers = {k: StandardScaler.from_dict(v)
               for k, v in meta.get("scalers", {}).items()}
    return params, meta["config"], scalers, meta.get("epoch")


def load_opt_leaves(path: str) -> Optional[List[np.ndarray]]:
    """The optimizer-state leaves of a resume checkpoint, in file order;
    None for a checkpoint without optimizer state, a reference ``.pt``
    included (a resume from one starts a fresh optimizer)."""
    try:
        zf = zipfile.ZipFile(path)
    except zipfile.BadZipFile:
        return None  # a legacy torch pickle
    with zf:
        if "opt.npz" not in zf.namelist():
            return None
        npz = np.load(io.BytesIO(zf.read("opt.npz")))
        return [npz[str(i)] for i in range(len(npz.files))]
