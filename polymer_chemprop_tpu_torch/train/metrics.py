"""Prediction-time metrics: the spectra ensemble uncertainty.

The port's copy of ``roundrobin_sid`` from polymer_chemprop_tpu
train/metrics.py; the training metrics come with the training slice.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


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
