"""Loss functions (reference utils.py:338-364 registry + train.py:67-74
masked aggregation); the port's counterpart of polymer_chemprop_tpu
train/loss.py.

All losses are elementwise with explicit mask/weight multiplication and
``sum / mask.sum()`` reduction, exactly as the reference trains. Spectra
losses (SID / Wasserstein) follow reference spectra_utils.py:9-159.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def bce_with_logits(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy on logits (torch BCEWithLogitsLoss)."""
    return preds.clamp(min=0) - preds * targets + \
        torch.log1p(torch.exp(-preds.abs()))


def mse(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (preds - targets) ** 2


def cross_entropy_multiclass(preds: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    """preds (M, tasks, classes) logits; targets (M, tasks) class ids.
    Returns (M, tasks) elementwise CE (CrossEntropyLoss reduction=none).

    The target's log-probability is picked by a comparison with the class
    ids, not by ``gather``: the VJP of ``gather`` adds into its output
    (on CUDA with atomics, in no fixed order), that of ``where`` writes.
    The other classes add exact zeros, and ``where`` (unlike a product
    with a one-hot) leaves no ``0 * -inf``."""
    logp = torch.log_softmax(preds, dim=-1)
    classes = torch.arange(preds.shape[-1], device=preds.device)
    pick = targets.long()[..., None] == classes
    return -torch.where(pick, logp, torch.zeros_like(logp)).sum(-1)


def sid_loss(preds: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
             threshold: Optional[float] = None) -> torch.Tensor:
    """Spectral information divergence (reference spectra_utils.py:9-40):
    predictions are thresholded, masked, normalized to sum 1; excluded
    positions are set to 1 on both sides so their log(1/1) term is zero."""
    if threshold is not None:
        preds = preds.clamp(min=threshold)
    on = mask > 0
    zero, one = torch.zeros_like(preds), torch.ones_like(preds)
    preds = torch.where(on, preds, zero)
    norm = preds.sum(dim=1, keepdim=True)
    preds = preds / torch.where(norm == 0, torch.ones_like(norm), norm)
    targets_ = torch.where(on, targets, one)
    preds = torch.where(on, preds, one)
    return preds * torch.log(preds / targets_) + \
        targets_ * torch.log(targets_ / preds)


def wasserstein_loss(preds: torch.Tensor, targets: torch.Tensor,
                     mask: torch.Tensor,
                     threshold: Optional[float] = None) -> torch.Tensor:
    """1-D earth-mover loss on normalized spectra via CDF differences
    (reference spectra_utils.py:86-128)."""
    if threshold is not None:
        preds = preds.clamp(min=threshold)
    on = mask > 0
    zero = torch.zeros_like(preds)
    preds = torch.where(on, preds, zero)
    targets_ = torch.where(on, targets, zero)
    norm = preds.sum(dim=1, keepdim=True)
    preds = preds / torch.where(norm == 0, torch.ones_like(norm), norm)
    return (torch.cumsum(preds, dim=1) - torch.cumsum(targets_, dim=1)).abs()


def get_loss_fn(dataset_type: str,
                alternative_loss_function: Optional[str] = None) -> Callable:
    """(reference utils.py get_loss_func:338-364)."""
    if alternative_loss_function is not None:
        if dataset_type == "spectra" and alternative_loss_function == "wasserstein":
            return wasserstein_loss
        raise ValueError(
            f"Alternative loss function {alternative_loss_function} not "
            f"supported with dataset type {dataset_type}.")
    if dataset_type == "classification":
        return bce_with_logits
    if dataset_type == "regression":
        return mse
    if dataset_type == "multiclass":
        return cross_entropy_multiclass
    if dataset_type == "spectra":
        return sid_loss
    raise ValueError(f'Dataset type "{dataset_type}" not supported.')


def masked_loss(elementwise: torch.Tensor, mask: torch.Tensor,
                target_weights: Optional[torch.Tensor],
                data_weights: torch.Tensor) -> torch.Tensor:
    """loss = sum(elem * target_w * data_w * mask) / max(sum(mask), 1)
    (reference train.py:67-74): the denominator counts real targets only."""
    x = elementwise * mask * data_weights
    if target_weights is not None:
        x = x * target_weights
    return x.sum() / mask.sum().clamp(min=1.0)
