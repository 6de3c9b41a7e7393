"""Data-parallel training over the ranks of a mesh axis.

The port's counterpart of polymer_chemprop_tpu parallel/dp.py. Every rank
holds the whole model and optimizer and trains on its own micro-batches
with the port's single-device forward and backward, so the encoder's
kernels (rows 1-3, and rows 4-7 in their configurations) run on every
rank.

The global masked loss is exact, not a mean of means: the mask
denominator is all-reduced before the forward, each rank divides its
numerator by that global denominator, and after the backward one flat
all-reduce sums the gradients (and the loss); every rank then steps the
port's optimizer on the same sum, so the parameters stay equal on every
rank and equal a single-device step on the concatenated batch.
``DistributedDataParallel`` is not used: its mean over ranks is not this
loss.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..train.loss import get_loss_fn
from ..train.step import TrainStep, pytree_tensors
from .mesh import Mesh, all_reduce_sum
from .partition import flat_all_reduce


def _tree_map(fn: Callable, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_device_batches(batches: List[Dict]) -> Dict:
    """Stack batch pytrees (``train.step.batch_pytree``) along a new leading
    axis (JAX dp.py:30-32); all must share one padding envelope."""
    return _tree_map(lambda *xs: np.stack(xs), *batches)


def shard_batch(batch_stacked: Dict, mesh: Mesh, axis: str = "dp",
                device="cuda") -> List[Dict]:
    """This rank's micro-batches of a ``(D, ...)`` stacked pytree as tensors
    on ``device`` (JAX dp.py:104-109): ``D`` is a multiple of the axis size
    and rank ``c`` of the axis takes entries ``[c L, (c + 1) L)``, ``L = D
    / size``, as a device of the JAX mesh takes its slice."""
    D = len(batch_stacked["targets"])
    n = mesh.shape[axis]
    if D % n:
        raise ValueError(f"{D} stacked batches do not split over {n} ranks")
    L = D // n
    c = mesh.coord(axis)
    return [pytree_tensors(_tree_map(lambda x: x[i], batch_stacked), device)
            for i in range(c * L, (c + 1) * L)]


class DPTrainStep(TrainStep):
    """:class:`~..train.step.TrainStep` over a list of this rank's
    micro-batches. ``loss_fn`` gives a micro-batch's masked loss
    numerator; the backward all-reduces the mask denominator over
    ``group`` first, then runs one backward a micro-batch of numerator /
    global denominator (so the local sum of two micro-batches is their
    gradients' sum, as the all-reduce of two ranks is); ``reduce`` then
    sums gradients and loss over ``group``."""

    def __init__(self, *args, group=None, **kwargs):
        super().__init__(*args, reduce=flat_all_reduce(group), **kwargs)
        self.group = group

    def backward(self, batches) -> torch.Tensor:
        local = sum(b["mask"].sum() for b in batches)
        denom = torch.clamp(all_reduce_sum(local, self.group), min=1.0)
        loss = None
        for batch in batches:
            part = self.loss_fn(self.model, batch, self.generator) / denom
            part.backward()
            loss = part.detach() if loss is None else loss + part.detach()
        return loss


def make_dp_train_step(model, optimizer, schedule, mesh: Mesh,
                       axis: str = "dp",
                       target_weights: Optional[torch.Tensor] = None,
                       alternative_loss_function: Optional[str] = None,
                       spectra_target_floor: Optional[float] = None,
                       grad_clip: Optional[float] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> DPTrainStep:
    """The data-parallel training step (JAX dp.py:35-101). Call it with this
    rank's micro-batches (:func:`shard_batch`); it returns ``(loss,
    gnorm)``, the global loss and the global gradient norm, the same on
    every rank of ``axis``. ``generator`` feeds this rank's dropout masks.
    Spectra losses normalize within each molecule, so the exact global
    loss holds for them unchanged."""
    cfg = model.cfg
    elementwise = get_loss_fn(cfg.dataset_type, alternative_loss_function)

    def numerator(model, batch, generator):
        preds = model(batch["graphs"], generator=generator,
                      features=batch.get("features"),
                      atom_descriptors=batch.get("atom_descriptors"))
        targets, mask = batch["targets"], batch["mask"]
        if cfg.dataset_type == "multiclass":
            preds = preds.reshape(preds.shape[0], -1,
                                  cfg.multiclass_num_classes)
            elem = elementwise(preds, targets)
        elif cfg.dataset_type == "spectra":
            elem = elementwise(preds, targets, mask, spectra_target_floor)
        else:
            elem = elementwise(preds, targets)
        x = elem * mask * batch["weights"]
        if target_weights is not None:
            x = x * target_weights
        return x.sum()

    return DPTrainStep(model, optimizer, schedule, numerator,
                       grad_clip=grad_clip, generator=generator,
                       group=mesh.group(axis))
