"""The loss closure and one optimizer step.

The port's counterpart of polymer_chemprop_tpu train/step.py (reference
train.py:39-88): forward, masked loss, backward, clip, optimizer step and
the per-step learning rate. Nothing here reads a value back from the
device: loss and gradient norm are returned as tensors, and the trainer
fetches an epoch's worth at once.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models.encoder import batch_to_tensors
from ..models.model import ModelConfig, MoleculeModel
from .loss import get_loss_fn, masked_loss
from .scheduler import Schedule


def model_inputs(device_batch, device) -> Dict:
    """The model's inputs of a DeviceBatch as tensors on ``device``: the
    graphs, and the molecule features ``(M, F)`` and atom descriptors
    ``(A, D)`` when the batch has them (JAX step.py:31-34, 47-48)."""
    d = {"graphs": [batch_to_tensors(g, device)
                    for g in device_batch.graph_arrays]}
    for key in ("features", "atom_descriptors"):
        value = getattr(device_batch, key)
        if value is not None:
            d[key] = torch.as_tensor(value, dtype=torch.float32,
                                     device=device)
    return d


def batch_pytree(device_batch) -> Dict:
    """A DeviceBatch as the JAX package's batch pytree of host arrays
    (JAX step.py ``batch_pytree``): ``graphs`` (one array dict a molecule
    position), ``targets``, ``mask``, ``weights``, and ``features`` /
    ``atom_descriptors`` when present. The parallel modules group and
    stack these."""
    d = {"graphs": list(device_batch.graph_arrays),
         "targets": device_batch.targets, "mask": device_batch.mask,
         "weights": device_batch.data_weights}
    for key in ("features", "atom_descriptors"):
        if getattr(device_batch, key) is not None:
            d[key] = getattr(device_batch, key)
    return d


def pytree_tensors(tree: Dict, device) -> Dict:
    """A batch pytree (:func:`batch_pytree`) as tensors on ``device``, in
    the layout of :func:`batch_tensors`."""
    d = {"graphs": [batch_to_tensors(g, device) for g in tree["graphs"]]}
    for key, value in tree.items():
        if key != "graphs":
            d[key] = torch.as_tensor(value, dtype=torch.float32,
                                     device=device)
    return d


def batch_tensors(device_batch, device) -> Dict:
    """DeviceBatch (host arrays) -> tensors on ``device``: the model's
    inputs, targets, mask and loss weights."""
    return pytree_tensors(batch_pytree(device_batch), device)


def make_loss_fn(cfg: ModelConfig,
                 target_weights: Optional[torch.Tensor] = None,
                 alternative_loss_function: Optional[str] = None,
                 spectra_target_floor: Optional[float] = None) -> Callable:
    """``loss_fn(model, batch, generator) -> scalar``: the masked training
    loss of one batch; ``generator`` feeds dropout in training mode."""
    elementwise = get_loss_fn(cfg.dataset_type, alternative_loss_function)

    def loss_fn(model: MoleculeModel, batch: Dict,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        preds = model(batch["graphs"], generator=generator,
                      features=batch.get("features"),
                      atom_descriptors=batch.get("atom_descriptors"))
        targets, mask = batch["targets"], batch["mask"]
        if cfg.dataset_type == "multiclass":
            preds3 = preds.reshape(preds.shape[0], -1,
                                   cfg.multiclass_num_classes)
            elem = elementwise(preds3, targets)
        elif cfg.dataset_type == "spectra":
            elem = elementwise(preds, targets, mask, spectra_target_floor)
        else:
            elem = elementwise(preds, targets)
        return masked_loss(elem, mask, target_weights, batch["weights"])

    return loss_fn


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((t.detach() ** 2).sum() for t in tensors))


class TrainStep:
    """One optimizer update per call, returning ``(loss, gnorm)`` as
    tensors on the model's device.

    * ``gnorm`` is the global norm of the gradients of ALL parameters,
      frozen ones included, before clipping.
    * Clipping scales the optimizer's (trainable) gradients by
      ``max / max(norm, max)`` with ``norm`` taken over them.
    * The learning rate of update ``k`` (0-based) is ``schedule(k)``;
      ``count`` is that ``k``, saved and restored with the optimizer state.
    * ``reduce(params, loss) -> loss``, when given, runs after the backward:
      the parallel steps sum the gradients and the loss over their ranks
      there (parallel/partition.py ``flat_all_reduce``).
    """

    def __init__(self, model: MoleculeModel, optimizer: torch.optim.Optimizer,
                 schedule: Schedule, loss_fn: Callable,
                 grad_clip: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 reduce: Optional[Callable] = None):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.loss_fn = loss_fn
        self.grad_clip = grad_clip
        self.generator = generator
        self.reduce = reduce
        self.count = 0
        self._trainable = [p for g in optimizer.param_groups
                           for p in g["params"]]

    def backward(self, batch) -> torch.Tensor:
        """The loss of ``batch``, its gradients accumulated into ``.grad``."""
        loss = self.loss_fn(self.model, batch, self.generator)
        loss.backward()
        return loss.detach()

    def __call__(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        self.model.train()
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        loss = self.backward(batch)
        if self.reduce is not None:
            loss = self.reduce(params, loss)
        gnorm = global_norm([p.grad for p in params if p.grad is not None])
        if self.grad_clip:
            grads = [p.grad for p in self._trainable if p.grad is not None]
            norm = gnorm if len(grads) == len(params) else global_norm(grads)
            scale = self.grad_clip / norm.clamp(min=self.grad_clip)
            for g in grads:
                g.mul_(scale)
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1
        return loss, gnorm
