"""Evaluation metric registry (reference utils.py:367-487) and
evaluate_predictions (reference train/evaluate.py:11-80).

The port's counterpart of polymer_chemprop_tpu train/metrics.py, written
with numpy and scipy only: each metric computes what the scikit-learn
function behind the JAX package's metric computes.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
from scipy.stats import rankdata


def _arrays(targets, preds):
    return np.asarray(targets, dtype=float), np.asarray(preds, dtype=float)


def mse_metric(targets, preds) -> float:
    t, p = _arrays(targets, preds)
    return float(np.mean((t - p) ** 2))


def rmse(targets, preds) -> float:
    return math.sqrt(mse_metric(targets, preds))


def mae(targets, preds) -> float:
    t, p = _arrays(targets, preds)
    return float(np.mean(np.abs(t - p)))


def r2(targets, preds) -> float:
    """Coefficient of determination; a constant target scores 1.0 when
    matched exactly and 0.0 otherwise."""
    t, p = _arrays(targets, preds)
    ss_res = float(np.sum((t - p) ** 2))
    ss_tot = float(np.sum((t - t.mean()) ** 2))
    if ss_tot == 0.0:
        return 1.0 if ss_res == 0.0 else 0.0
    return 1.0 - ss_res / ss_tot


def roc_auc(targets, preds) -> float:
    """Area under the ROC curve as the Mann-Whitney statistic with average
    ranks for ties (equal to the trapezoid over the ROC curve)."""
    t, p = _arrays(targets, preds)
    pos = t == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score "
                         "is not defined in that case.")
    ranks = rankdata(p)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def prc_auc(targets, preds) -> float:
    """Trapezoid area under the precision-recall curve: one point per
    distinct score threshold (descending), closed at recall 0 with
    precision 1."""
    t, p = _arrays(targets, preds)
    order = np.argsort(-p, kind="mergesort")
    t, p = t[order], p[order]
    distinct = np.r_[np.where(np.diff(p))[0], t.size - 1]
    tps = np.cumsum(t == 1)[distinct].astype(float)
    fps = (1 + distinct - tps).astype(float)
    precision = np.r_[(tps / (tps + fps))[::-1], 1.0]
    recall = np.r_[(tps / tps[-1])[::-1], 0.0]
    # recall falls along the curve, so the trapezoid sum is negated
    return float(-np.sum(np.diff(recall)
                         * (precision[1:] + precision[:-1]) / 2.0))


def bce_metric(targets, preds) -> float:
    eps = 1e-7
    p = np.clip(np.asarray(preds, dtype=float), eps, 1 - eps)
    t = np.asarray(targets, dtype=float)
    return float(np.mean(-(t * np.log(p) + (1 - t) * np.log(1 - p))))


def accuracy(targets, preds, threshold: float = 0.5) -> float:
    if isinstance(preds[0], (list, np.ndarray)):
        hard = [int(np.argmax(p)) for p in preds]
    else:
        hard = [1 if p > threshold else 0 for p in preds]
    return float(np.mean(np.asarray(targets) == np.asarray(hard)))


def cross_entropy(targets, preds, labels=None) -> float:
    """Multiclass log loss: probabilities (n, classes) clipped to
    [eps, 1 - eps] (float64 machine eps), true class by label index."""
    p = np.asarray(preds, dtype=float)
    if p.ndim == 1:
        p = np.stack([1 - p, p], axis=1)
    labels = list(range(p.shape[1])) if labels is None else list(labels)
    idx = np.asarray([labels.index(t) for t in targets])
    eps = np.finfo(p.dtype).eps
    p = np.clip(p, eps, 1 - eps)
    return float(-np.mean(np.log(p[np.arange(p.shape[0]), idx])))


def sid_metric(model_spectra, target_spectra,
               threshold: Optional[float] = None) -> float:
    """(reference spectra_utils.py:42-83): mean summed SID per spectrum,
    averaged over all spectra as the JAX package does."""
    preds = np.array(model_spectra, dtype=float)
    masks = np.array([[x is not None for x in b] for b in target_spectra])
    targets = np.array([[1.0 if x is None else x for x in b]
                        for b in target_spectra])
    if threshold is not None:
        preds[preds < threshold] = threshold
    preds[~masks] = 0
    preds = preds / np.sum(preds, axis=1, keepdims=True)
    preds[~masks] = 1
    loss = preds * np.log(preds / targets) + targets * np.log(targets / preds)
    return float(np.mean(np.sum(loss, axis=1)))


def wasserstein_metric(model_spectra, target_spectra,
                       threshold: Optional[float] = None) -> float:
    """(reference spectra_utils.py:131-159)."""
    preds = np.array(model_spectra, dtype=float)
    masks = np.array([[x is not None for x in b] for b in target_spectra])
    targets = np.array([[0.0 if x is None else x for x in b]
                        for b in target_spectra])
    if threshold is not None:
        preds[preds < threshold] = threshold
    preds[~masks] = 0
    preds = preds / np.sum(preds, axis=1, keepdims=True)
    loss = np.abs(np.cumsum(preds, axis=1) - np.cumsum(targets, axis=1))
    return float(np.mean(np.sum(loss, axis=1)))


def roundrobin_sid(spectra: np.ndarray,
                   threshold: Optional[float] = None) -> List[float]:
    """Average pairwise SID across ensemble members per spectrum — the
    spectra-ensemble uncertainty measure (reference spectra_utils.py:211-241).

    spectra: (num_spectra, spectrum_length, ensemble_size)."""
    out = []
    for spectrum in np.array(spectra, dtype=float):
        nan_mask = np.isnan(spectrum[:, 0])
        if threshold is not None:
            spectrum[spectrum < threshold] = threshold
        spectrum[nan_mask, :] = 1
        ensemble_size = spectrum.shape[1]
        pair_losses = []
        for a in range(ensemble_size):
            for b in range(a + 1, ensemble_size):
                pa, pb = spectrum[:, a], spectrum[:, b]
                loss = pa * np.log(pa / pb) + pb * np.log(pb / pa)
                loss[nan_mask] = 0
                pair_losses.append(loss.sum())
        out.append(float(np.mean(pair_losses)) if pair_losses else 0.0)
    return out


METRICS: Dict[str, Callable] = {
    "auc": roc_auc,
    "prc-auc": prc_auc,
    "rmse": rmse,
    "mse": mse_metric,
    "mae": mae,
    "r2": r2,
    "accuracy": accuracy,
    "cross_entropy": cross_entropy,
    "binary_cross_entropy": bce_metric,
    "sid": sid_metric,
    "wasserstein": wasserstein_metric,
}


def get_metric_fn(metric: str) -> Callable:
    if metric not in METRICS:
        raise ValueError(f'Metric "{metric}" not supported.')
    return METRICS[metric]


def minimize_score(metric: str) -> bool:
    """Whether lower is better (reference args.py:456-460)."""
    return metric in {"rmse", "mae", "mse", "cross_entropy",
                      "binary_cross_entropy", "sid", "wasserstein"}


def evaluate_predictions(preds: List[List[float]],
                         targets: List[List[Optional[float]]],
                         num_tasks: int,
                         metrics: List[str],
                         dataset_type: str) -> Dict[str, List[float]]:
    """Per-task metric evaluation with None filtering and degenerate-class
    guards (reference train/evaluate.py:11-80)."""
    if len(preds) == 0:
        return {metric: [float("nan")] * num_tasks for metric in metrics}

    if dataset_type == "spectra":
        return {metric: [get_metric_fn(metric)(preds, targets)]
                for metric in metrics}

    valid_preds: List[List] = [[] for _ in range(num_tasks)]
    valid_targets: List[List] = [[] for _ in range(num_tasks)]
    for i in range(len(preds)):
        for j in range(num_tasks):
            if targets[i][j] is not None:
                valid_preds[j].append(preds[i][j])
                valid_targets[j].append(targets[i][j])

    results: Dict[str, List[float]] = {metric: [] for metric in metrics}
    for j in range(num_tasks):
        nan = len(valid_targets[j]) == 0
        if dataset_type == "classification":
            if all(t == 0 for t in valid_targets[j]) or \
                    all(t == 1 for t in valid_targets[j]):
                nan = True
            if all(p == 0 for p in valid_preds[j]) or \
                    all(p == 1 for p in valid_preds[j]):
                nan = True
        if nan:
            for metric in metrics:
                results[metric].append(float("nan"))
            continue
        for metric in metrics:
            fn = get_metric_fn(metric)
            if dataset_type == "multiclass" and metric == "cross_entropy":
                results[metric].append(fn(
                    valid_targets[j], valid_preds[j],
                    labels=list(range(len(valid_preds[j][0])))))
            else:
                results[metric].append(fn(valid_targets[j], valid_preds[j]))
    return results
