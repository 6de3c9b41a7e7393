"""Standard scaler with NaN-aware statistics (reference data/scaler.py:6-63)."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np


class StandardScaler:
    """Per-column z-normalization fit with nanmean/nanstd; zero-variance and
    all-NaN columns degrade to identity (mean 0 / std 1), as the reference
    does via its nan replacement tokens."""

    def __init__(self, means: Optional[np.ndarray] = None,
                 stds: Optional[np.ndarray] = None,
                 replace_nan_token: Any = None):
        self.means = means
        self.stds = stds
        self.replace_nan_token = replace_nan_token

    def fit(self, X) -> "StandardScaler":
        X = np.array(X, dtype=float)
        self.means = np.nanmean(X, axis=0)
        self.stds = np.nanstd(X, axis=0)
        self.means = np.where(np.isnan(self.means), np.zeros(self.means.shape),
                              self.means)
        self.stds = np.where(np.isnan(self.stds), np.ones(self.stds.shape),
                             self.stds)
        # degenerate-variance guard: the reference guards exact zeros
        # (data/scaler.py:77); float-noise stds (a column whose values
        # tie up to 1 ulp, e.g. a CDF-normalized plateau) must degrade
        # to identity too — dividing by ~1e-17 overflows float32
        # downstream (r5). The threshold is RELATIVE to the column's
        # value magnitude (max |x|), so a column in genuinely tiny
        # units with proportionally tiny variance is untouched.
        with np.errstate(invalid="ignore"):
            scale = np.nanmax(np.abs(X), axis=0)
        scale = np.where(np.isfinite(scale), scale, 0.0)
        self.stds = np.where(self.stds <= 1e-12 * scale,
                             np.ones(self.stds.shape), self.stds)
        return self

    def transform(self, X) -> np.ndarray:
        X = np.array(X, dtype=float)
        out = (X - self.means) / self.stds
        if self.replace_nan_token is not None:
            out = np.where(np.isnan(out), self.replace_nan_token, out)
        return out

    def inverse_transform(self, X) -> np.ndarray:
        X = np.array(X, dtype=float)
        out = X * self.stds + self.means
        if self.replace_nan_token is not None:
            out = np.where(np.isnan(out), self.replace_nan_token, out)
        return out

    def to_dict(self) -> dict:
        return {
            "means": None if self.means is None else np.asarray(self.means).tolist(),
            "stds": None if self.stds is None else np.asarray(self.stds).tolist(),
        }

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["StandardScaler"]:
        if d is None:
            return None
        means = None if d.get("means") is None else np.asarray(d["means"])
        stds = None if d.get("stds") is None else np.asarray(d["stds"])
        return cls(means=means, stds=stds)
