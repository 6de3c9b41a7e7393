"""MoleculeModel: wD-MPNN encoder(s) + feed-forward head, in PyTorch.

The port's counterpart of polymer_chemprop_tpu models/model.py (reference
models/model.py:14-195, models/mpn.py:176-289): one encoder per molecule
position (optionally shared), position encodings concatenated, the batch's
molecule-level features appended (``use_input_features``), then an FFN
whose output is exp/softplus-activated for spectra; :func:`postprocess_preds`
applies the eval-time sigmoid (classification) or softmax (multiclass). A
``features_only`` model has no encoder: the FFN reads the features alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
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
    features_size: int = 0        # molecule-level extra features width
    features_only: bool = False
    use_input_features: bool = False
    spectra_activation: str = "exp"
    atom_descriptors: Optional[str] = None
    atom_descriptors_size: int = 0

    @property
    def output_size(self) -> int:
        n = self.num_tasks
        if self.dataset_type == "multiclass":
            n *= self.multiclass_num_classes
        return n

    @property
    def first_linear_dim(self) -> int:
        """FFN input width (reference model.py:66-74)."""
        if self.features_only:
            return self.features_size
        dim = self.encoder.hidden_size * self.number_of_molecules
        if self.use_input_features:
            dim += self.features_size
        if self.atom_descriptors == "descriptor":
            dim += self.atom_descriptors_size
        return dim


def widened_featurization(cfg, data=None):
    """``cfg.featurization()`` widened by the dataset's extra per-atom and
    per-bond features (JAX trainer.py:189-200). The extra width counts with
    the ``overwrite_default_*`` flags too, where it is the whole width."""
    fcfg = cfg.featurization()
    if data is not None and len(data):
        sample = data[0]
        if sample.atom_features is not None:
            fcfg = fcfg.replace(
                extra_atom_fdim=np.asarray(sample.atom_features).shape[1])
        if sample.bond_features is not None:
            fcfg = fcfg.replace(
                extra_bond_fdim=np.asarray(sample.bond_features).shape[1])
    return fcfg


def build_model_config(cfg, num_tasks: int, data=None) -> ModelConfig:
    """ModelConfig from a TrainConfig (the JAX package's train/trainer.py
    build_model_config). ``data`` (the training set, or the set to predict)
    gives the widths of the extra inputs: molecule features, atom
    descriptors and extra atom/bond features."""
    fcfg = widened_featurization(cfg, data)
    features_size = data.features_size() if data is not None else 0
    descriptors_size = data.atom_descriptors_size() \
        if data is not None else 0
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
        atom_descriptors_size=descriptors_size,
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
        features_size=features_size,
        features_only=cfg.features_only,
        use_input_features=features_size > 0,
        spectra_activation=cfg.spectra_activation,
        atom_descriptors=cfg.atom_descriptors,
        atom_descriptors_size=descriptors_size,
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
    molecule position (``encoders`` then holds one module); with
    ``features_only`` there is none (JAX model.py:67)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        n_enc = 0 if cfg.features_only else \
            1 if cfg.mpn_shared else cfg.number_of_molecules
        self.encoders = nn.ModuleList(MPNEncoder(cfg.encoder)
                                      for _ in range(n_enc))
        self.ffn = nn.ModuleList(nn.Linear(i, o) for i, o in ffn_dims(cfg))
        self.act = get_activation(cfg.encoder.activation)

    def encode(self, batches: Sequence[Dict[str, torch.Tensor]],
               generator: Optional[torch.Generator] = None,
               features: Optional[torch.Tensor] = None,
               atom_descriptors: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """Concatenated per-position molecule encodings, then the molecule
        features ``(M, F)`` when the model uses them (reference
        mpn.py:210-289, JAX model.py:92-111). ``atom_descriptors``
        ``(A, D)`` goes to every encoder (the ``"descriptor"`` mode). A
        ``features_only`` model's encoding is the features."""
        if self.cfg.features_only:
            return features
        encodings = [
            self.encoders[0 if self.cfg.mpn_shared else i](
                b, generator, atom_descriptors)
            for i, b in enumerate(batches)]
        out = torch.cat(encodings, 1) if len(encodings) > 1 else encodings[0]
        if self.cfg.use_input_features and features is not None:
            out = torch.cat([out, features], 1)
        return out

    def forward(self, batches: Sequence[Dict[str, torch.Tensor]],
                return_embeddings: bool = False,
                generator: Optional[torch.Generator] = None,
                features: Optional[torch.Tensor] = None,
                atom_descriptors: Optional[torch.Tensor] = None):
        """Raw predictions (spectra activation applied; sigmoid/softmax are
        left to :func:`postprocess_preds`, reference model.py:152-194). In
        training mode the FFN is dropout -> linear [-> act -> dropout ->
        linear]* (reference model.py:79-100), masks from ``generator``."""
        emb = self.encode(batches, generator, features, atom_descriptors)
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
                    fingerprint_type: str = "MPN",
                    features: Optional[torch.Tensor] = None,
                    atom_descriptors: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """Latent representations (reference model.py:123-150): the
        encoding of :meth:`encode`, molecule features included ("MPN"),
        or the FFN's input to its last layer ("last_FFN")."""
        if fingerprint_type not in ("MPN", "last_FFN"):
            raise ValueError(
                f"Unsupported fingerprint type {fingerprint_type}.")
        emb = self.encode(batches, None, features, atom_descriptors)
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
