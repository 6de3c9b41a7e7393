"""The system under test: the PyTorch and CUDA port, built as its own entry
points build it (``train/trainer.py``, ``train/make_predictions.py``), from
the benchmark's configuration file and inputs. Every import of the port is
made here, inside functions."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import data


def train_config(cfg: dict, batch_size: int):
    """The port's TrainConfig of a configuration file."""
    from polymer_chemprop_tpu_torch.config import TrainConfig
    return TrainConfig(
        dataset_type=cfg["dataset_type"], polymer=cfg["polymer"],
        hidden_size=cfg["hidden_size"], depth=cfg["depth"],
        ffn_num_layers=cfg["ffn_num_layers"],
        ffn_hidden_size=cfg["ffn_hidden_size"],
        activation=cfg["activation"], aggregation=cfg["aggregation"],
        bias=cfg["bias"], dropout=cfg["dropout"],
        band_precision=cfg["band_precision"], optimizer=cfg["optimizer"],
        scheduler=cfg["scheduler"], epochs=cfg["epochs"],
        warmup_epochs=cfg["warmup_epochs"], init_lr=cfg["init_lr"],
        max_lr=cfg["max_lr"], final_lr=cfg["final_lr"],
        batch_size=batch_size)


def dataset(smiles: Sequence[str], targets: Optional[np.ndarray] = None):
    """A MoleculeDataset of one molecule a row, with float targets when
    given."""
    from polymer_chemprop_tpu_torch.data.datapoint import (
        MoleculeDatapoint, MoleculeDataset)
    return MoleculeDataset([
        MoleculeDatapoint([s], None if targets is None
                          else [float(t) for t in targets[i]])
        for i, s in enumerate(smiles)])


def loader(ds, tcfg, batch_size: int, shuffle: bool = False, seed: int = 0):
    """The loader as the trainer and ``make_predictions`` build it: the C++
    featurizer and the default pool."""
    from polymer_chemprop_tpu_torch.data import MoleculeDataLoader
    return MoleculeDataLoader(ds, tcfg.featurization(),
                              batch_size=batch_size, shuffle=shuffle,
                              seed=seed, num_workers=tcfg.num_workers,
                              use_native=tcfg.use_native_featurizer)


def model(tcfg, num_tasks: int, leaves, names, device):
    """A MoleculeModel on ``device`` holding the benchmark's weights,
    loaded as a checkpoint's are, through ``models/convert.py``
    ``load_jax_params``."""
    from polymer_chemprop_tpu_torch.models.convert import load_jax_params
    from polymer_chemprop_tpu_torch.models.model import (
        MoleculeModel, build_model_config)
    with torch.device(device):
        m = MoleculeModel(build_model_config(tcfg, num_tasks))
    load_jax_params(m, data.jax_tree(leaves, names))
    return m


def param_leaf(name: str) -> str:
    """A model parameter's leaf name: ``encoders.0.W_h.weight`` ->
    ``W_h.w``, ``ffn.1.bias`` -> ``ffn1.b``."""
    parts = name.split(".")
    kind = "w" if parts[-1] == "weight" else "b"
    if parts[0] == "ffn":
        return f"ffn{parts[1]}.{kind}"
    return f"{parts[2]}.{kind}"


def train_step(m, tcfg, steps_per_epoch: int):
    """The trainer's single-device step: the Noam schedule, Adam, the
    masked loss and ``TrainStep``."""
    from polymer_chemprop_tpu_torch.train.scheduler import (
        build_optimizer, build_schedule)
    from polymer_chemprop_tpu_torch.train.step import TrainStep, make_loss_fn
    schedule = build_schedule(
        tcfg.scheduler, init_lr=tcfg.init_lr, max_lr=tcfg.max_lr,
        final_lr=tcfg.final_lr, warmup_epochs=tcfg.warmup_epochs,
        epochs=tcfg.epochs, steps_per_epoch=steps_per_epoch)
    optimizer = build_optimizer(tcfg.optimizer, m.parameters(),
                                tcfg.weight_decay)
    return TrainStep(m, optimizer, schedule, make_loss_fn(m.cfg),
                     grad_clip=tcfg.grad_clip)


def batch_tensors(batch, device):
    from polymer_chemprop_tpu_torch.train.step import batch_tensors as bt
    return bt(batch, device)


def predict(m, batches, device, scaler_means, scaler_stds):
    """``train/predict.py`` ``predict`` over ``batches`` with the target
    scaler a checkpoint carries; returns ``(n, T)`` predictions."""
    from polymer_chemprop_tpu_torch.data.scaler import StandardScaler
    from polymer_chemprop_tpu_torch.train.predict import predict as pred
    preds, _ = pred(m, batches, device,
                    scaler=StandardScaler(scaler_means, scaler_stds))
    return np.asarray(preds, dtype=float)
