"""Evaluation = predict + evaluate_predictions (reference train/evaluate.py:83-118)."""

from __future__ import annotations

from typing import Dict, List, Optional

from ..data import MoleculeDataLoader, StandardScaler
from ..models.model import MoleculeModel
from .metrics import evaluate_predictions
from .predict import predict


def evaluate(model: MoleculeModel, data_loader: MoleculeDataLoader,
             num_tasks: int, metrics: List[str], dataset_type: str, device,
             scaler: Optional[StandardScaler] = None) -> Dict[str, List[float]]:
    preds, _ = predict(model, data_loader, device, scaler=scaler)
    return evaluate_predictions(
        preds=preds,
        targets=data_loader.targets(),
        num_tasks=num_tasks,
        metrics=metrics,
        dataset_type=dataset_type,
    )
