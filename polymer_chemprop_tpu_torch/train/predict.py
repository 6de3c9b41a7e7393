"""Batch prediction over a data loader (reference train/predict.py:10-68)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data import MoleculeDataLoader, StandardScaler
from ..models.model import MoleculeModel, postprocess_preds
from .step import model_inputs


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument. A CUDA
    device without a GPU raises: the port never falls back to the CPU on
    its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


@torch.inference_mode()
def predict(model: MoleculeModel, data_loader: MoleculeDataLoader,
            device, scaler: Optional[StandardScaler] = None,
            return_embeddings: bool = False
            ) -> Tuple[List[List[float]], Optional[np.ndarray]]:
    """Eval-mode forward over all batches on ``device``; trims padding rows
    and inverse-transforms targets when a scaler is given
    (reference predict.py:54-55)."""
    model.eval()
    all_preds: List[np.ndarray] = []
    all_embeddings: List[np.ndarray] = []
    for batch in data_loader:
        b = model_inputs(batch, device)
        preds, emb = model(b["graphs"], return_embeddings=True,
                           features=b.get("features"),
                           atom_descriptors=b.get("atom_descriptors"))
        preds = postprocess_preds(preds, model.cfg)
        all_preds.append(preds.cpu().numpy()[:batch.size])
        if return_embeddings:
            all_embeddings.append(emb.cpu().numpy()[:batch.size])
    preds = np.concatenate(all_preds, axis=0) if all_preds else np.zeros((0, 0))
    if scaler is not None:
        preds = scaler.inverse_transform(preds)
    emb = np.concatenate(all_embeddings, axis=0) if all_embeddings else None
    return preds.tolist(), emb
