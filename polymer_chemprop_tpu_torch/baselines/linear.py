"""Least squares for ``impute_mode="linear"``: the counterpart of
scikit-learn's ``LinearRegression`` as the JAX package's
``impute_targets`` uses it (polymer_chemprop_tpu/sklearn_train.py:67-71).

sklearn centres X and y and takes the minimum-norm least-squares solution
of scipy's ``lstsq``, with singular values below ``max(n, F) * eps`` times
the largest cut. With n molecules below the 2,048 Morgan bits the system is
underdetermined; CUDA's ``lstsq`` takes only full-rank tall systems, so the
port takes the pseudo-inverse (an SVD, ``torch.linalg.pinv``, whose
default cut is that same ``max(n, F) * eps``) on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def linear_fit_predict(X_fit: np.ndarray, y_fit: np.ndarray,
                       X_pred: np.ndarray, device) -> np.ndarray:
    """Fit ``y ≈ X coef + intercept`` on the fit rows and predict the
    others, in float64 on ``device``."""
    X = torch.as_tensor(np.asarray(X_fit, dtype=np.float64), device=device)
    y = torch.as_tensor(np.asarray(y_fit, dtype=np.float64), device=device)
    Xp = torch.as_tensor(np.asarray(X_pred, dtype=np.float64), device=device)
    x_mean, y_mean = X.mean(0), y.mean()
    coef = torch.linalg.pinv(X - x_mean) @ (y - y_mean)
    intercept = y_mean - x_mean @ coef
    return (Xp @ coef + intercept).cpu().numpy()
