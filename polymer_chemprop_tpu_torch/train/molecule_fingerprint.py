"""Latent-representation extraction (reference
train/molecule_fingerprint.py:16-190).

The port's counterpart of polymer_chemprop_tpu train/molecule_fingerprint.py:
the encoders' molecule embeddings ("MPN") or the FFN's input to its last
layer ("last_FFN") of every input row, from one or more JAX-format
``.ckpt`` files stacked side by side, run on ``args.device`` (CUDA unless
the caller asks for the CPU). The extra inputs and each member's feature
scalers flow through as in make_predictions, and so does its model, one
encoder per molecule position: the "MPN" fingerprint is the positions'
encodings side by side, then the molecule features, and a
``"descriptor"`` model applies W_d to the given atom descriptors (the JAX
package's reads no descriptor files). Rows that do not parse keep their
place in the CSV with 'Invalid SMILES' placeholders.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ..config import PredictConfig, find_checkpoints
from ..data import MoleculeDataLoader, partition_valid
from ..models.convert import load_jax_params
from ..models.model import build_model_config
from .make_predictions import (
    _num_tasks,
    apply_scalers,
    load_model,
    load_prediction_data,
    serving_model,
    update_prediction_args,
)
from .predict import resolve_device
from .step import model_inputs


@dataclasses.dataclass
class FingerprintConfig(PredictConfig):
    fingerprint_type: str = "MPN"  # MPN | last_FFN (reference args.py:731-735)


def _write_csv(path: str, full_data, width: int, row_of) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles"] + [f"fp_{i}" for i in range(width)])
        for i, d in enumerate(full_data):
            row = row_of(i)
            w.writerow([".".join(d.smiles)] +
                       (["Invalid SMILES"] * width if row is None
                        else list(row)))


def molecule_fingerprint(args: FingerprintConfig) -> np.ndarray:
    """``(valid rows, width x checkpoints)`` fingerprints; with
    ``args.preds_path`` also the CSV of every input row."""
    device = resolve_device(args.device)
    ckpts = find_checkpoints(args.checkpoint_dir, args.checkpoint_path,
                             args.checkpoint_paths)
    best = [c for c in ckpts if os.path.basename(c) == "best_model.ckpt"]
    if best:
        ckpts = best
    if not ckpts:
        raise ValueError("No checkpoints given or found.")

    _, tcfg, _ = load_model(ckpts[0])
    fcfg = tcfg.featurization()
    update_prediction_args(args, tcfg)
    # keep unparseable rows so the output preserves every input row with
    # 'Invalid SMILES' placeholders (reference molecule_fingerprint.py:44-60)
    full_data, _ = load_prediction_data(args, tcfg, fcfg)
    full_to_valid, test_data = partition_valid(full_data, fcfg)
    model_cfg = build_model_config(tcfg, _num_tasks(tcfg), data=test_data)
    if len(test_data) == 0:
        # all rows unparseable: placeholder CSV at the fingerprint width
        width = (model_cfg.ffn_hidden_size if args.fingerprint_type ==
                 "last_FFN" else model_cfg.first_linear_dim) * len(ckpts)
        if args.preds_path:
            _write_csv(args.preds_path, full_data, width, lambda i: None)
        return np.zeros((0, width))
    loader = MoleculeDataLoader(test_data, fcfg, batch_size=args.batch_size,
                                num_workers=args.num_workers,
                                use_native=args.use_native_featurizer)
    model = serving_model(model_cfg).to(device).eval()

    all_fps = []
    for ckpt in ckpts:
        params, _, scalers = load_model(ckpt)
        load_jax_params(model, params)
        apply_scalers(test_data, scalers)
        fps = []
        with torch.inference_mode():
            for batch in loader:
                b = model_inputs(batch, device)
                out = model.fingerprint(
                    b["graphs"], args.fingerprint_type,
                    features=b.get("features"),
                    atom_descriptors=b.get("atom_descriptors"))
                fps.append(out.cpu().numpy()[:batch.size])
        all_fps.append(np.concatenate(fps, axis=0))
    stacked = np.concatenate(all_fps, axis=1)

    if args.preds_path:
        _write_csv(args.preds_path, full_data, stacked.shape[1],
                   lambda i: None if full_to_valid.get(i) is None
                   else stacked[full_to_valid[i]])
    return stacked


def chemprop_fingerprint(argv: Optional[List[str]] = None) -> None:
    """CLI entry (reference molecule_fingerprint.py:185-190)."""
    import argparse

    from ..config import _add_field_args
    parser = argparse.ArgumentParser(
        prog="polymer_chemprop_tpu_torch fingerprint")
    _add_field_args(parser, FingerprintConfig)
    ns = parser.parse_args(argv)
    known = {f.name for f in dataclasses.fields(FingerprintConfig)}
    molecule_fingerprint(FingerprintConfig(
        **{k: v for k, v in vars(ns).items() if k in known}))
