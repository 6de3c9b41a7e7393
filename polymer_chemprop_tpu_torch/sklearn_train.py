"""Random-forest / SVM baselines on Morgan fingerprints, on the card.

The port's counterpart of polymer_chemprop_tpu sklearn_train.py (reference
sklearn_train.py:59-363), name for name. The JAX package fits
scikit-learn's estimators on the host; the port fits its own on
``cfg.device`` (``"cuda"`` unless asked for ``"cpu"``): the forests and
SVMs of baselines/, which import no scikit-learn. It runs through the
same ``cross_validate`` as the MPNN (``train_func=run_sklearn``), with the
single-task and multi-task paths and the imputation modes.

What differs from the JAX package on purpose: the random draws (the port's
forests and the SVC's Platt folds are seeded from ``cfg.seed``; sklearn's
are its own streams, and the JAX package leaves the SVC's unseeded), and
``model.pkl`` is the port's format (baselines/pickles.py), which the JAX
package's ``predict_sklearn`` cannot read; the port reads both.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from .baselines.forest import RandomForestClassifier, RandomForestRegressor
from .baselines.linear import linear_fit_predict
from .baselines.pickles import save_bundle
from .baselines.svm import SVC, SVR
from .config import TrainConfig
from .data import MoleculeDataset, split_data
from .features.generators import morgan_binary_features_generator
from .train.cross_validate import cross_validate
from .train.metrics import evaluate_predictions
from .train.predict import resolve_device
from .train.trainer import _write_test_preds
from .utils.logging import timeit


@dataclasses.dataclass
class SklearnTrainConfig(TrainConfig):
    """(reference SklearnTrainArgs, args.py:767-786); ``device`` comes from
    ``TrainConfig``."""

    model_type: str = "random_forest"  # random_forest | svm
    class_weight: Optional[str] = None
    single_task: bool = False
    radius: int = 2
    num_bits: int = 2048
    num_trees: int = 500
    impute_mode: Optional[str] = None  # single_task | linear | median | mean | frequent


def compute_morgan_features(data: MoleculeDataset, radius: int,
                            num_bits: int) -> np.ndarray:
    return np.stack([
        morgan_binary_features_generator(d.smiles[0], radius=radius,
                                         num_bits=num_bits)
        for d in data])


def impute_targets(X: np.ndarray, y: List[List[Optional[float]]],
                   cfg: SklearnTrainConfig) -> np.ndarray:
    """Missing-target imputation (reference sklearn_train.py:59-128)."""
    arr = np.array([[np.nan if v is None else v for v in row] for row in y],
                   dtype=float)
    for t in range(arr.shape[1]):
        col = arr[:, t]
        missing = np.isnan(col)
        if not missing.any():
            continue
        present = col[~missing]
        if cfg.impute_mode == "median":
            fill = np.nanmedian(col)
        elif cfg.impute_mode == "mean":
            fill = np.nanmean(col)
        elif cfg.impute_mode == "frequent":
            vals, counts = np.unique(present, return_counts=True)
            fill = vals[np.argmax(counts)]
        elif cfg.impute_mode == "linear":
            arr[missing, t] = linear_fit_predict(
                X[~missing], present, X[missing], resolve_device(cfg.device))
            continue
        elif cfg.impute_mode == "single_task":
            model = _build_model(cfg, single=True)
            model.fit(X[~missing], present)
            arr[missing, t] = model.predict(X[missing])
            continue
        else:
            raise ValueError(f"Invalid impute_mode {cfg.impute_mode!r}")
        arr[missing, t] = fill
    return arr


def _build_model(cfg: SklearnTrainConfig, single: bool = False):
    device = resolve_device(cfg.device)
    if cfg.dataset_type == "regression":
        if cfg.model_type == "random_forest":
            return RandomForestRegressor(n_estimators=cfg.num_trees,
                                         random_state=cfg.seed,
                                         device=device)
        if cfg.model_type == "svm":
            return SVR(device=device)
    elif cfg.dataset_type == "classification":
        if cfg.model_type == "random_forest":
            return RandomForestClassifier(n_estimators=cfg.num_trees,
                                          class_weight=cfg.class_weight,
                                          random_state=cfg.seed,
                                          device=device)
        if cfg.model_type == "svm":
            return SVC(probability=True, random_state=cfg.seed,
                       device=device)
    raise ValueError(f"Model type {cfg.model_type!r} with dataset type "
                     f"{cfg.dataset_type!r} not supported")


def _predict(model, X: np.ndarray, dataset_type: str,
             num_tasks: int) -> np.ndarray:
    """(reference sklearn_train.py:132-170 predict)."""
    if dataset_type == "regression":
        preds = model.predict(X)
        return preds.reshape(len(X), num_tasks)
    proba = model.predict_proba(X)
    if isinstance(proba, list):  # multi-task classifier
        return np.stack([p[:, 1] for p in proba], axis=1)
    return proba[:, 1].reshape(len(X), 1)


def run_sklearn(cfg: SklearnTrainConfig, data: MoleculeDataset,
                logger=None) -> dict:
    """Train/eval one fold (reference sklearn_train.py:250-356)."""
    info = logger.info if logger else print
    info(f"Computing morgan fingerprints (radius {cfg.radius}, "
         f"{cfg.num_bits} bits)")
    train_data, _, test_data = split_data(
        data, cfg.split_type, cfg.split_sizes, cfg.seed, cfg.num_folds,
        cfg.folds_file, cfg.val_fold_index, cfg.test_fold_index)

    X_train = compute_morgan_features(train_data, cfg.radius, cfg.num_bits)
    X_test = compute_morgan_features(test_data, cfg.radius, cfg.num_bits)

    num_tasks = data.num_tasks or 1
    if cfg.impute_mode:
        y_train = impute_targets(X_train, train_data.targets(), cfg)
    else:
        y_train = np.array([[np.nan if v is None else v for v in row]
                            for row in train_data.targets()], dtype=float)

    trained_models = []
    if cfg.single_task or num_tasks == 1 or np.isnan(y_train).any():
        # per-task models (reference single-task path, sklearn_train.py:172-213)
        preds = np.zeros((len(test_data), num_tasks))
        for t in range(num_tasks):
            col = y_train[:, t]
            ok = ~np.isnan(col)
            model = _build_model(cfg)
            model.fit(X_train[ok], col[ok])
            trained_models.append(model)
            preds[:, t] = _predict(model, X_test, cfg.dataset_type, 1)[:, 0]
    else:
        model = _build_model(cfg)
        model.fit(X_train, y_train if num_tasks > 1 else y_train[:, 0])
        trained_models.append(model)
        preds = _predict(model, X_test, cfg.dataset_type, num_tasks)

    if cfg.save_dir:
        os.makedirs(cfg.save_dir, exist_ok=True)
        save_bundle(os.path.join(cfg.save_dir, "model.pkl"), trained_models,
                    cfg.to_dict(), num_tasks)
        if cfg.save_preds and len(test_data) > 0:
            _write_test_preds(cfg.save_dir, test_data, preds.tolist())

    scores = evaluate_predictions(preds.tolist(), test_data.targets(),
                                  num_tasks, cfg.metrics, cfg.dataset_type)
    for metric, vals in scores.items():
        info(f"Test {metric} = {np.nanmean(vals):.6f}")
    if cfg.save_dir:
        with open(os.path.join(cfg.save_dir, "test_scores.json"), "w") as f:
            json.dump(scores, f, indent=4, sort_keys=True)
    return scores


@timeit()
def sklearn_train(argv: Optional[List[str]] = None):
    """CLI entry (reference sklearn_train.py:358-363)."""
    import argparse
    import sys
    from .config import _add_field_args
    parser = argparse.ArgumentParser(prog="sklearn_train")
    _add_field_args(parser, SklearnTrainConfig)
    ns = parser.parse_args(sys.argv[1:] if argv is None else argv)
    d = vars(ns)
    if d.get("split_sizes") is not None:
        d["split_sizes"] = tuple(d["split_sizes"])
    known = {f.name for f in dataclasses.fields(SklearnTrainConfig)}
    cfg = SklearnTrainConfig(**{k: v for k, v in d.items() if k in known})
    return cross_validate(cfg, train_func=run_sklearn)
