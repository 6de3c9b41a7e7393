"""MoleculeModel: wD-MPNN encoder(s) + feed-forward head, in PyTorch.

The port's counterpart of polymer_chemprop_tpu models/model.py (reference
models/model.py:14-195, models/mpn.py:176-289): one encoder per molecule
position (optionally shared), position encodings concatenated, then an FFN
whose output is exp/softplus-activated for spectra; :func:`postprocess_preds`
applies the eval-time sigmoid (classification) or softmax (multiclass).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from .encoder import EncoderConfig, MPNEncoder
from .nn import dropout, get_activation, linear


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (the JAX package's ModelConfig)."""

    encoder: EncoderConfig
    dataset_type: str = "regression"  # regression|classification|multiclass|spectra
    num_tasks: int = 1
    multiclass_num_classes: int = 3
    number_of_molecules: int = 1
    mpn_shared: bool = False
    ffn_num_layers: int = 2
    ffn_hidden_size: int = 300
    spectra_activation: str = "exp"

    @property
    def output_size(self) -> int:
        n = self.num_tasks
        if self.dataset_type == "multiclass":
            n *= self.multiclass_num_classes
        return n

    @property
    def first_linear_dim(self) -> int:
        """FFN input width (reference model.py:66-74)."""
        return self.encoder.hidden_size * self.number_of_molecules


def build_model_config(cfg, num_tasks: int) -> ModelConfig:
    """ModelConfig from a checkpoint's TrainConfig (the JAX package's
    train/trainer.py build_model_config)."""
    if cfg.features_only:
        raise NotImplementedError("not on the port yet: features_only "
                                  "(molecule-level extra features)")
    fcfg = cfg.featurization()
    enc = EncoderConfig(
        atom_fdim=fcfg.atom_fdim,
        bond_fdim=fcfg.bond_fdim(cfg.atom_messages),
        hidden_size=cfg.hidden_size,
        depth=cfg.depth,
        dropout=cfg.dropout,
        activation=cfg.activation,
        aggregation=cfg.aggregation,
        aggregation_norm=cfg.aggregation_norm,
        bias=cfg.bias,
        undirected=cfg.undirected,
        atom_messages=cfg.atom_messages,
        atom_descriptors=cfg.atom_descriptors,
        compute_dtype="bfloat16" if cfg.param_dtype in ("bfloat16", "bf16")
        else "float32",
        band_precision=cfg.band_precision,
    )
    return ModelConfig(
        encoder=enc,
        dataset_type=cfg.dataset_type,
        num_tasks=num_tasks,
        multiclass_num_classes=cfg.multiclass_num_classes,
        number_of_molecules=cfg.number_of_molecules,
        mpn_shared=cfg.mpn_shared,
        ffn_num_layers=cfg.ffn_num_layers,
        ffn_hidden_size=cfg.ffn_hidden_size,
        spectra_activation=cfg.spectra_activation,
    )


def ffn_dims(cfg: ModelConfig) -> List[tuple]:
    """(in, out) of each FFN layer (reference model.py:79-100)."""
    if cfg.ffn_num_layers == 1:
        return [(cfg.first_linear_dim, cfg.output_size)]
    dims = [(cfg.first_linear_dim, cfg.ffn_hidden_size)]
    dims += [(cfg.ffn_hidden_size, cfg.ffn_hidden_size)] * (
        cfg.ffn_num_layers - 2)
    dims.append((cfg.ffn_hidden_size, cfg.output_size))
    return dims


class MoleculeModel(nn.Module):
    """Encoders + FFN head. With ``mpn_shared`` one encoder serves every
    molecule position (``encoders`` then holds one module)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        n_enc = 1 if cfg.mpn_shared else cfg.number_of_molecules
        self.encoders = nn.ModuleList(MPNEncoder(cfg.encoder)
                                      for _ in range(n_enc))
        self.ffn = nn.ModuleList(nn.Linear(i, o) for i, o in ffn_dims(cfg))
        self.act = get_activation(cfg.encoder.activation)

    def encode(self, batches: Sequence[Dict[str, torch.Tensor]],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Concatenated per-position molecule encodings
        (reference mpn.py:210-289)."""
        encodings = [
            self.encoders[0 if self.cfg.mpn_shared else i](b, generator)
            for i, b in enumerate(batches)]
        return torch.cat(encodings, 1) if len(encodings) > 1 else encodings[0]

    def forward(self, batches: Sequence[Dict[str, torch.Tensor]],
                return_embeddings: bool = False,
                generator: Optional[torch.Generator] = None):
        """Raw predictions (spectra activation applied; sigmoid/softmax are
        left to :func:`postprocess_preds`, reference model.py:152-194). In
        training mode the FFN is dropout -> linear [-> act -> dropout ->
        linear]* (reference model.py:79-100), masks from ``generator``."""
        emb = self.encode(batches, generator)
        h = self.apply_ffn(emb, generator)
        if self.cfg.dataset_type == "spectra":
            h = F.softplus(h) if self.cfg.spectra_activation == "softplus" \
                else torch.exp(h)
        return (h, emb) if return_embeddings else h

    def apply_ffn(self, h: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  truncate_last: bool = False) -> torch.Tensor:
        """The FFN head; ``truncate_last`` stops before its last linear
        layer (last_FFN fingerprints, reference model.py:146-148)."""
        bf16 = self.cfg.encoder.compute_dtype == "bfloat16"
        for i, layer in enumerate(self.ffn):
            if i > 0:
                h = self.act(h)
            h = dropout(h, self.cfg.encoder.dropout, self.training, generator)
            if truncate_last and i == len(self.ffn) - 1:
                break
            h = linear(layer, h, bf16)
        return h

    def fingerprint(self, batches: Sequence[Dict[str, torch.Tensor]],
                    fingerprint_type: str = "MPN") -> torch.Tensor:
        """Latent representations (reference model.py:123-150): the
        encoders' output ("MPN") or the FFN's input to its last layer
        ("last_FFN")."""
        if fingerprint_type not in ("MPN", "last_FFN"):
            raise ValueError(
                f"Unsupported fingerprint type {fingerprint_type}.")
        emb = self.encode(batches)
        if fingerprint_type == "MPN":
            return emb
        return self.apply_ffn(emb, truncate_last=True)


def postprocess_preds(preds: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Eval-time post-processing (reference model.py:181-188)."""
    if cfg.dataset_type == "classification":
        return torch.sigmoid(preds)
    if cfg.dataset_type == "multiclass":
        preds = preds.reshape(preds.shape[0], -1, cfg.multiclass_num_classes)
        return torch.softmax(preds, dim=2)
    return preds
