"""Self-supervised pretraining for polymer wD-MPNNs, in PyTorch.

The port's counterpart of polymer_chemprop_tpu ssl.py (reference
ssl_two_stage_V5_C.py, ssl_enhancements.py):

* node/edge masking task: mask a fraction (with a per-graph minimum) of
  atoms and directed bond pairs by zeroing their features and reconstruct
  the original features with MSE;
* graph-level task: regress a stoichiometry-weighted molecular-weight
  pseudo-label scaled by the degree of polymerization;
* two stages: masking only, then masking plus the graph head with a loss
  weight; plateau decay and early stopping on the training loss or on a
  held-out fraction;
* enhanced mode: edge-loss weight, warm-up and cosine over each stage,
  stochastic perturbation of inter-monomer edge weights;
* export for ``checkpoint_frzn`` in the downstream MoleculeModel layout
  (transfer strategies 'a' encoder, 'b' and 'c' encoder + graph head).

The encoder is the port's MPNEncoder on its sorted branch (the kernels of
ops/band_mpnn.py on a card) at ``band_precision="highest"``: the JAX step
multiplies in FP32 outside the band kernels, so this is the function it
computes. Bond rows are dst-sorted there, while the JAX package draws its
bond masks over natural bond order, so masks are drawn in natural order and
permuted by the batch's ``perm``; the edge loss is a masked mean and does
not depend on the order. Masking is split into :func:`draw_masks` (the
random numbers, from an explicit ``torch.Generator``) and
:func:`apply_masks` (the masks and masked inputs from those numbers), so
the JAX package's own draws can be fed to the application.

As in the JAX package, the *gradients* are scaled by the stage's LR scale
before Adam (ssl.py:218), not the learning rate; under Adam that leaves
warm-up, cosine and plateau decay nearly inert. No dropout is applied
whatever ``dropout`` says (the JAX ``encode_parts`` has none).
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import TrainConfig
from .data import MoleculeDataLoader, MoleculeDataset, get_data
from .models.convert import ssl_params_to_jax
from .models.encoder import EncoderConfig, MPNEncoder, batch_to_tensors
from .models.init import init_model
from .models.nn import get_activation, linear
from .ops.band_mpnn import molecule_readout_sorted
from .train.predict import resolve_device
from .train.scheduler import build_optimizer, constant_schedule
from .train.step import global_norm
from .utils.checkpoint import save_checkpoint
from .utils.logging import get_logger


@dataclasses.dataclass
class SSLConfig:
    """(reference ssl_two_stage_V5_C.py:733-766 CLI surface); the JAX
    package's SSLConfig plus ``device``."""

    data_path: str = ""
    save_dir: Optional[str] = None
    polymer: bool = True
    hidden_size: int = 300
    depth: int = 3
    mask_ratio: float = 0.15
    min_mask: int = 2           # per-graph minimum masked atoms
    graph_loss_weight: float = 0.5
    use_enhanced_ssl: bool = False
    edge_loss_weight: float = 1.5
    augment_ratio: float = 0.3
    epochs_stage1: int = 20
    epochs_stage2: int = 10
    batch_size: int = 50
    lr: float = 1e-3
    lr_graph: Optional[float] = None   # stage-2 LR (defaults to lr)
    dropout: float = 0.0
    weight_decay: float = 0.0
    pretrain_frac: float = 1.0
    val_frac: float = 0.0       # held-out fraction for early stopping
    pretrain_folds_file: Optional[str] = None  # pickle of pretrain indices
    save_graph_embeddings: bool = False
    graph_embeddings_path: Optional[str] = None
    seed: int = 0
    patience: int = 5
    lr_decay: float = 0.5
    transfer_strategy: str = "a"  # a: encoder, b: +2 FC, c: all
    num_workers: int = 4
    max_data_size: Optional[int] = None
    quiet: bool = False
    # where the model runs: "cuda" (the default; raises without a GPU) or
    # "cpu" (the plain PyTorch versions of the kernels)
    device: str = "cuda"


def molecular_weight_label(dataset: MoleculeDataset, cfg_feat) -> np.ndarray:
    """Stoichiometry-weighted molecular weight pseudo-label, Xn-scaled and
    standardized (reference ssl_two_stage_V5_C.py:301-319). The mass
    channel is the last atom feature (0.01 * amu)."""
    labels = []
    for d in dataset:
        g = d.mol_graphs(cfg_feat)[0]
        masses = np.asarray([f[132] * 100.0 for f in g.f_atoms])
        w = np.asarray(g.w_atoms)
        labels.append(float((masses * w).sum()) * g.degree_of_polym)
    arr = np.asarray(labels, np.float32)
    return (arr - arr.mean()) / max(arr.std(), 1e-8)


class SSLModel(nn.Module):
    """Encoder + node, edge and graph heads (reference SSLPretrainModel,
    ssl_two_stage_V5_C.py:140-180; JAX ssl.py:103-114)."""

    def __init__(self, enc_cfg: EncoderConfig):
        super().__init__()
        H = enc_cfg.hidden_size
        self.encoder = MPNEncoder(enc_cfg)
        self.node_head = nn.Linear(H, enc_cfg.atom_fdim)
        self.edge_head = nn.Linear(H, enc_cfg.bond_fdim)
        self.graph_head = nn.ModuleList([nn.Linear(H, H), nn.Linear(H, 1)])
        self.act = get_activation(enc_cfg.activation)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(message, atom_hiddens, mol_emb)``: final bond messages in the
        batch's order, atom hiddens, and the weighted atom sum scaled by
        the degree of polymerization."""
        message, atom_hiddens = self.encoder.encode_parts(batch)
        mol_emb = molecule_readout_sorted(
            atom_hiddens, batch["w_atoms"], batch["a2mol"],
            batch["sorted_aux"], batch["degree_of_polym"], aggregation="sum")
        return message, atom_hiddens, mol_emb


def init_ssl_model(enc_cfg: EncoderConfig, seed: int) -> SSLModel:
    """Xavier-normal weights and zero biases (JAX init_linear), from a
    generator seeded with ``seed``; on the CPU."""
    return init_model(SSLModel(enc_cfg),
                      torch.Generator().manual_seed(seed))


def draw_masks(generator: torch.Generator, n_atoms: int, n_bonds: int,
               augment: bool) -> Dict[str, torch.Tensor]:
    """The random numbers of one masked step, on the generator's device:
    ``atom`` (A,) and ``pair`` (B // 2,) uniforms; with ``augment`` the
    gate's uniform ``gate`` () and the standard normal ``noise`` (B,) in
    natural bond order."""
    kw = dict(generator=generator, device=generator.device)
    draws = {"atom": torch.rand(n_atoms, **kw),
             "pair": torch.rand(n_bonds // 2, **kw)}
    if augment:
        draws["gate"] = torch.rand((), **kw)
        draws["noise"] = torch.randn(n_bonds, **kw)
    return draws


def _rank_in_molecule(score: torch.Tensor, a2mol: torch.Tensor
                      ) -> torch.Tensor:
    """Each atom's rank by ``score`` within its molecule (a segmented
    sort); the JAX count of lower scores when no two scores tie."""
    order = torch.sort(score, stable=True).indices
    order = order[torch.sort(a2mol[order], stable=True).indices]
    counts = torch.bincount(a2mol)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(a2mol)
    rank[order] = torch.arange(score.shape[0], device=score.device) \
        - start[a2mol[order]]
    return rank


def apply_masks(batch: Dict, draws: Dict[str, torch.Tensor],
                mask_ratio: float, min_mask: int = 0,
                augment_ratio: float = 0.0):
    """``(masked batch, atom_mask, bond_mask)`` from ``draws`` (JAX
    ssl.py:117-154 and the augmentation of :197-207). The masks are bool
    over the padded axes; ``bond_mask`` is in the batch's bond order
    (dst-sorted with ``"sorted_aux"``). With ``draws["noise"]`` the
    inter-monomer weights (0 < w < 1) are perturbed when the gate's
    uniform is below ``augment_ratio``."""
    aux = batch.get("sorted_aux")
    f_atoms, f_bonds = batch["f_atoms"], batch["f_bonds"]
    A, B = f_atoms.shape[0], f_bonds.shape[0]
    w = batch["w_bonds"]
    if "noise" in draws:
        inter = (w > 0) & (w < 1.0)
        w_aug = torch.where(inter, torch.clamp(w + draws["noise"] * 0.05,
                                               0.01, 0.99), w)
        w = torch.where(draws["gate"] < augment_ratio, w_aug, w)
    real_atom = batch["w_atoms"] > 0
    real_bond = w > 0
    if min_mask > 0:
        # mask the max(min_mask, ratio * n_g) lowest-scoring atoms a graph
        a2mol = batch["a2mol"]
        score = torch.where(real_atom, draws["atom"],
                            torch.full_like(draws["atom"], 2.0))
        rank = _rank_in_molecule(score, a2mol)
        num_mols = batch["degree_of_polym"].shape[0]
        n_g = torch.zeros(num_mols, dtype=torch.int64, device=w.device)
        n_g.index_add_(0, a2mol, real_atom.long())
        k_g = torch.maximum(torch.clamp(n_g, max=min_mask),
                            (mask_ratio * n_g).long())
        atom_mask = (rank < k_g[a2mol]) & real_atom
    else:
        atom_mask = (draws["atom"] < mask_ratio) & real_atom
    bond_mask = (draws["pair"] < mask_ratio).repeat_interleave(2)
    if B % 2:
        bond_mask = torch.cat([bond_mask, bond_mask.new_zeros(1)])
    # bond rows start at 1 in (fwd, rev) pairs: roll the mask by one slot
    bond_mask = torch.roll(bond_mask, 1) & real_bond
    masked = dict(batch)
    masked["w_bonds"] = w
    if aux is not None:
        perm = aux["perm"].long()
        bond_mask = bond_mask[perm]
        masked["sorted_aux"] = dict(aux, w_sorted=w[perm].contiguous())
    zero = f_atoms.new_zeros(())
    masked["f_atoms"] = torch.where(atom_mask[:, None], zero, f_atoms)
    masked["f_bonds"] = torch.where(bond_mask[:, None], zero, f_bonds)
    return masked, atom_mask, bond_mask


class SSLStep:
    """The masked loss and one update (JAX ``make_ssl_step``). Call with a
    batch of tensors, its labels (M,) and its draws; returns ``(loss,
    gnorm)`` as tensors (gnorm before the LR scale)."""

    def __init__(self, model: SSLModel, optimizer: torch.optim.Optimizer,
                 lr: float, mask_ratio: float, graph_loss_weight: float,
                 min_mask: int = 0, edge_loss_weight: float = 1.0,
                 augment_ratio: float = 0.0):
        self.model = model
        self.optimizer = optimizer
        self.lr = constant_schedule(lr)(0)
        self.mask_ratio = mask_ratio
        self.graph_loss_weight = graph_loss_weight
        self.min_mask = min_mask
        self.edge_loss_weight = edge_loss_weight
        self.augment_ratio = augment_ratio

    def draws(self, batch: Dict, generator: torch.Generator) -> Dict:
        return draw_masks(generator, batch["f_atoms"].shape[0],
                          batch["f_bonds"].shape[0], self.augment_ratio > 0)

    def loss(self, batch: Dict, labels: torch.Tensor, draws: Dict,
             with_graph: bool) -> torch.Tensor:
        model = self.model
        masked, atom_mask, bond_mask = apply_masks(
            batch, draws, self.mask_ratio, self.min_mask, self.augment_ratio)
        message, atom_hiddens, mol_emb = model(masked)
        node_rec = linear(model.node_head, atom_hiddens)
        edge_rec = linear(model.edge_head, message)
        node_se = ((node_rec - batch["f_atoms"]) ** 2).mean(1)
        edge_se = ((edge_rec - batch["f_bonds"]) ** 2).mean(1)
        am, bm = atom_mask.float(), bond_mask.float()
        node_loss = (node_se * am).sum() / am.sum().clamp(min=1)
        edge_loss = (edge_se * bm).sum() / bm.sum().clamp(min=1)
        loss = node_loss + self.edge_loss_weight * edge_loss
        if with_graph:
            h = model.act(linear(model.graph_head[0], mol_emb))
            pred = linear(model.graph_head[1], h)[:, 0]
            gmask = batch["mol_mask"]
            graph_loss = (((pred - labels) ** 2) * gmask).sum() / \
                gmask.sum().clamp(min=1)
            loss = loss + self.graph_loss_weight * graph_loss
        return loss

    def __call__(self, batch: Dict, labels: torch.Tensor, draws: Dict,
                 with_graph: bool, lr_scale: float = 1.0):
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        loss = self.loss(batch, labels, draws, with_graph)
        loss.backward()
        # a head outside this stage's loss gets a zero gradient, so that
        # every parameter counts every update, as optax's one count does
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        gnorm = global_norm([p.grad for p in params])
        for p in params:
            p.grad.mul_(lr_scale)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
        self.optimizer.step()
        return loss.detach(), gnorm


def ssl_batches(loader: MoleculeDataLoader, labels_all: np.ndarray, device):
    """``(batch tensors, labels (M,))`` of each loader batch."""
    offset = 0
    for batch in loader:
        labels = np.zeros(batch.targets.shape[0], np.float32)
        labels[:batch.size] = labels_all[offset:offset + batch.size]
        offset += batch.size
        yield (batch_to_tensors(batch.graph_arrays[0], device),
               torch.as_tensor(labels, device=device))


def ssl_epoch(step: SSLStep, loader, labels_all, device,
              generator: torch.Generator, with_graph: bool,
              lr_scale: float, train: bool = True) -> Tuple[float, int]:
    """One pass over ``loader``: updates when ``train``, else the loss
    alone (JAX's zero-scaled step, its update thrown away). Returns the
    mean loss and the number of batches; losses are read back once."""
    losses = []
    for batch, labels in ssl_batches(loader, labels_all, device):
        draws = step.draws(batch, generator)
        if train:
            loss, _ = step(batch, labels, draws, with_graph, lr_scale)
        else:
            with torch.no_grad():
                loss = step.loss(batch, labels, draws, with_graph)
        losses.append(loss)
    return float(torch.stack(losses).mean().cpu()) if losses \
        else float("nan"), len(losses)


def enhanced_lr(epoch: int, epochs: int) -> float:
    """10% -> 100% linear warm-up, then cosine decay over the stage
    (ssl_enhancements.py:25-45)."""
    warm = max(1, min(5, epochs // 10))
    if epoch < warm:
        return 0.1 + 0.9 * epoch / warm
    return 0.5 * (1 + math.cos(
        math.pi * (epoch - warm) / max(1, epochs - warm)))


def load_ssl_data(cfg: SSLConfig):
    """``(fcfg, train data, val data or None)``: the pretraining subset
    (a folds file, else a seeded fraction) and the held-out split."""
    fcfg = TrainConfig(data_path=cfg.data_path, polymer=cfg.polymer,
                       dataset_type="regression").featurization()
    data = get_data(cfg.data_path, config=fcfg, target_columns=[],
                    max_data_size=cfg.max_data_size)
    if cfg.pretrain_folds_file:
        with open(cfg.pretrain_folds_file, "rb") as f:
            idx = list(pickle.load(f))
        if idx and isinstance(idx[0], (list, tuple)):
            idx = [i for fold in idx for i in fold]
        data = MoleculeDataset([data[i] for i in idx if i < len(data)])
    elif cfg.pretrain_frac < 1.0:
        rnd = random.Random(cfg.seed)
        idx = list(range(len(data)))
        rnd.shuffle(idx)
        keep = idx[:max(1, int(len(data) * cfg.pretrain_frac))]
        data = MoleculeDataset([data[i] for i in sorted(keep)])
    val_data = None
    if cfg.val_frac > 0 and len(data) > 4:
        n_val = max(1, int(len(data) * cfg.val_frac))
        rnd = random.Random(cfg.seed + 1)
        idx = list(range(len(data)))
        rnd.shuffle(idx)
        val_idx = set(idx[:n_val])
        val_data = MoleculeDataset([data[i] for i in sorted(val_idx)])
        data = MoleculeDataset([data[i] for i in range(len(data))
                                if i not in val_idx])
    return fcfg, data, val_data


def ssl_encoder_config(cfg: SSLConfig, fcfg) -> EncoderConfig:
    return EncoderConfig(atom_fdim=fcfg.atom_fdim, bond_fdim=fcfg.bond_fdim(),
                         hidden_size=cfg.hidden_size, depth=cfg.depth,
                         dropout=cfg.dropout, band_precision="highest")


def make_ssl_step(cfg: SSLConfig, model: SSLModel) -> SSLStep:
    optimizer = build_optimizer("adamw" if cfg.weight_decay > 0 else "adam",
                                model.parameters(), cfg.weight_decay)
    return SSLStep(
        model, optimizer, cfg.lr, cfg.mask_ratio, cfg.graph_loss_weight,
        min_mask=cfg.min_mask,
        edge_loss_weight=cfg.edge_loss_weight if cfg.use_enhanced_ssl
        else 1.0,
        augment_ratio=cfg.augment_ratio if cfg.use_enhanced_ssl else 0.0)


def ssl_pretrain(cfg: SSLConfig) -> str:
    """Two-stage pretraining on ``cfg.device``; returns the checkpoint
    path consumed by ``checkpoint_frzn`` downstream (reference
    run_training.py:272-285)."""
    device = resolve_device(cfg.device)
    log = get_logger("ssl", cfg.save_dir, cfg.quiet)
    fcfg, data, val_data = load_ssl_data(cfg)
    labels_all = molecular_weight_label(data, fcfg)
    val_labels = molecular_weight_label(val_data, fcfg) \
        if val_data is not None else None

    enc_cfg = ssl_encoder_config(cfg, fcfg)
    model = init_ssl_model(enc_cfg, cfg.seed).to(device)
    step = make_ssl_step(cfg, model)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    loader = MoleculeDataLoader(data, fcfg, batch_size=cfg.batch_size,
                                shuffle=False, num_workers=cfg.num_workers)
    val_loader = MoleculeDataLoader(val_data, fcfg,
                                    batch_size=cfg.batch_size,
                                    shuffle=False,
                                    num_workers=cfg.num_workers) \
        if val_data is not None else None

    def run_stage(epochs: int, with_graph: bool, stage: int) -> None:
        # stage-2 LR override (reference --learning_rate_graph)
        base_scale = (cfg.lr_graph / cfg.lr) \
            if (with_graph and cfg.lr_graph) else 1.0
        best = float("inf")
        bad_epochs = 0
        lr_scale = base_scale
        for epoch in range(epochs):
            if cfg.use_enhanced_ssl:
                lr_scale = base_scale * enhanced_lr(epoch, epochs)
            t0 = time.perf_counter()
            train_loss, n_steps = ssl_epoch(step, loader, labels_all, device,
                                            generator, with_graph, lr_scale)
            epoch_s = time.perf_counter() - t0
            if val_loader is not None:
                crit, _ = ssl_epoch(step, val_loader, val_labels, device,
                                    generator, with_graph, 0.0, train=False)
            else:
                crit = train_loss
            log.debug(f"[stage {stage}] epoch {epoch} loss "
                      f"{train_loss:.5f} crit {crit:.5f} "
                      f"(lr x{lr_scale:.3f}), "
                      f"{n_steps / max(epoch_s, 1e-9):.1f} steps/s")
            if crit < best - 1e-5:
                best = crit
                bad_epochs = 0
            else:
                bad_epochs += 1
                if bad_epochs >= cfg.patience:
                    log.info(f"[stage {stage}] early stop at epoch {epoch}")
                    break
                lr_scale *= cfg.lr_decay  # plateau decay

    log.info("SSL stage 1: node/edge masking")
    run_stage(cfg.epochs_stage1, False, 1)
    log.info("SSL stage 2: masking + graph-level pseudo-label")
    run_stage(cfg.epochs_stage2, True, 2)

    # the downstream MoleculeModel layout: encoder (+ the graph head as
    # the first FFN layers for strategies b and c)
    params = ssl_params_to_jax(model)
    export: Dict = {"encoders": [params["encoder"]]}
    if cfg.transfer_strategy in ("b", "c"):
        export["ffn"] = params["graph_head"]
    path = os.path.join(cfg.save_dir or ".", "ssl_pretrained.ckpt")
    save_checkpoint(path, export, dataclasses.asdict(cfg),
                    extra_meta={"ssl": True,
                                "transfer_strategy": cfg.transfer_strategy})
    log.info(f"Saved SSL checkpoint to {path}")

    if cfg.save_graph_embeddings:
        emb_path = cfg.graph_embeddings_path or \
            os.path.join(cfg.save_dir or ".", "ssl_graph_embeddings.npy")
        np.save(emb_path, graph_embeddings(model, enc_cfg, loader, device))
        log.info(f"Saved graph embeddings to {emb_path}")
    return path


def graph_embeddings(model: SSLModel, enc_cfg: EncoderConfig, loader,
                     device) -> np.ndarray:
    """The trained encoder's molecule encodings of ``loader``'s molecules
    (reference --save_graph_embeddings), through the encoder's forward at
    the default ``band_precision`` "high", as the JAX package runs
    ``apply_encoder``."""
    encoder = MPNEncoder(dataclasses.replace(enc_cfg, band_precision="high"))
    encoder.load_state_dict(model.encoder.state_dict())
    encoder.to(device).eval()
    chunks = []
    with torch.no_grad():
        for batch in loader:
            emb = encoder(batch_to_tensors(batch.graph_arrays[0], device))
            chunks.append(emb[:batch.size].cpu().numpy())
    return np.concatenate(chunks, axis=0)


def ssl_pretrain_cli(argv: Optional[List[str]] = None) -> str:
    import argparse

    from .config import _add_field_args
    parser = argparse.ArgumentParser(
        prog="polymer_chemprop_tpu_torch ssl_pretrain")
    _add_field_args(parser, SSLConfig)
    ns = parser.parse_args(argv)
    known = {f.name for f in dataclasses.fields(SSLConfig)}
    return ssl_pretrain(SSLConfig(**{k: v for k, v in vars(ns).items()
                                     if k in known}))
