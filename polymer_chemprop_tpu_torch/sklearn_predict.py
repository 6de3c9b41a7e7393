"""Prediction with trained baseline models (reference sklearn_predict.py:
15-82); the port's counterpart of polymer_chemprop_tpu sklearn_predict.py.

Reads ``model.pkl`` files of either format (baselines/pickles.py): the
port's own and the JAX package's scikit-learn pickles, the latter without
importing scikit-learn. The models run on ``args.device``.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import List, Optional

import numpy as np

from .baselines.pickles import load_bundle
from .config import PredictConfig
from .data import get_data
from .sklearn_train import (SklearnTrainConfig, _predict,
                            compute_morgan_features)
from .train.predict import resolve_device
from .utils.logging import timeit


def predict_sklearn(args: PredictConfig) -> List[List[float]]:
    model_paths = []
    if args.checkpoint_dir:
        for root, _, files in os.walk(args.checkpoint_dir):
            model_paths += [os.path.join(root, f) for f in files
                            if f == "model.pkl"]
    elif args.checkpoint_path:
        model_paths = [args.checkpoint_path]
    elif args.checkpoint_paths:
        model_paths = args.checkpoint_paths
    if not model_paths:
        raise ValueError("No sklearn model checkpoints found.")
    device = resolve_device(args.device)

    models, config, num_tasks = load_bundle(model_paths[0], device)
    cfg = SklearnTrainConfig.from_dict(config)

    test_data = get_data(args.test_path, args.smiles_columns,
                         target_columns=[], config=cfg.featurization(),
                         store_row=True)
    X = compute_morgan_features(test_data, cfg.radius, cfg.num_bits)

    sum_preds = np.zeros((len(test_data), num_tasks))
    for i, path in enumerate(model_paths):
        if i:
            models, _, _ = load_bundle(path, device)
        if len(models) == 1:
            sum_preds += _predict(models[0], X, cfg.dataset_type, num_tasks)
        else:
            for t, m in enumerate(models):
                sum_preds[:, t] += _predict(m, X, cfg.dataset_type, 1)[:, 0]
    avg_preds = sum_preds / len(model_paths)

    if args.preds_path:
        os.makedirs(os.path.dirname(args.preds_path) or ".", exist_ok=True)
        with open(args.preds_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["smiles"] + [f"task_{i}" for i in range(num_tasks)])
            for d, p in zip(test_data, avg_preds):
                w.writerow([".".join(d.smiles)] + list(p))
    return avg_preds.tolist()


@timeit()
def sklearn_predict(argv: Optional[List[str]] = None) -> None:
    """CLI entry (reference sklearn_predict.py:77-82)."""
    import argparse
    import sys
    from .config import _add_field_args
    parser = argparse.ArgumentParser(prog="sklearn_predict")
    _add_field_args(parser, PredictConfig)
    ns = parser.parse_args(sys.argv[1:] if argv is None else argv)
    known = {f.name for f in dataclasses.fields(PredictConfig)}
    predict_sklearn(PredictConfig(
        **{k: v for k, v in vars(ns).items() if k in known}))
