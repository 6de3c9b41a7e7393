"""Typed training/prediction configuration + the train and predict CLIs.

The port's copy of polymer_chemprop_tpu config.py: ``TrainConfig`` drives
training, is written into every checkpoint's metadata, and is read back
from it (``from_dict``) to yield the featurization.

Replaces the reference's Tap-based flag system (reference args.py, 820 LoC):
every field is simultaneously a CLI flag (see :func:`_add_field_args`), a
typed attribute, and JSON round-trippable (:meth:`TrainConfig.to_dict` /
:meth:`from_dict`) — the same three roles, without the global mutable
featurization state the reference smuggles through ``set_polymer`` et al.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional, Tuple

from .features import FeaturizationConfig


@dataclasses.dataclass
class TrainConfig:
    """Training configuration (reference TrainArgs, args.py:219-650)."""

    # data
    data_path: str = ""
    smiles_columns: Optional[List[str]] = None
    target_columns: Optional[List[str]] = None
    ignore_columns: Optional[List[str]] = None
    number_of_molecules: int = 1
    dataset_type: str = "regression"
    multiclass_num_classes: int = 3
    max_data_size: Optional[int] = None
    train_frac: float = 1.0                  # fork addition (args.py:306-307)
    separate_val_path: Optional[str] = None
    separate_test_path: Optional[str] = None
    # per-separate-set feature inputs (reference args.py:325-339)
    separate_val_features_path: Optional[List[str]] = None
    separate_test_features_path: Optional[List[str]] = None
    separate_val_phase_features_path: Optional[str] = None
    separate_test_phase_features_path: Optional[str] = None
    separate_val_atom_descriptors_path: Optional[str] = None
    separate_test_atom_descriptors_path: Optional[str] = None
    separate_val_bond_features_path: Optional[str] = None
    separate_test_bond_features_path: Optional[str] = None

    # features
    features_generator: Optional[List[str]] = None
    features_path: Optional[List[str]] = None
    phase_features_path: Optional[str] = None  # one-hot spectra phases (args.py:87)
    no_features_scaling: bool = False
    no_atom_descriptor_scaling: bool = False  # (args.py: fork scaling opt-outs)
    no_bond_features_scaling: bool = False
    no_cache_mol: bool = False               # disable the graph cache (args.py:107)
    atom_descriptors: Optional[str] = None   # 'feature' | 'descriptor'
    atom_descriptors_path: Optional[str] = None
    bond_features_path: Optional[str] = None
    overwrite_default_atom_features: bool = False
    overwrite_default_bond_features: bool = False

    # featurization modes
    polymer: bool = False                    # fork headline flag (args.py:360-363)
    reaction: bool = False
    reaction_mode: str = "reac_diff"
    explicit_h: bool = False
    adding_h: bool = False

    # splits
    split_type: str = "random"
    split_sizes: Tuple[float, float, float] = (0.8, 0.1, 0.1)
    num_folds: int = 1
    folds_file: Optional[str] = None
    val_fold_index: Optional[int] = None
    test_fold_index: Optional[int] = None
    train_fold_index: Optional[int] = None   # fork addition (args.py:254-255)
    crossval_index_dir: Optional[str] = None
    crossval_index_file: Optional[str] = None

    # general
    seed: int = 0
    pytorch_seed: int = 0                    # model-init / dropout seed
    metric: Optional[str] = None
    extra_metrics: List[str] = dataclasses.field(default_factory=list)
    save_dir: Optional[str] = None
    quiet: bool = False
    save_preds: bool = False
    show_individual_scores: bool = False  # per-task scores (args.py:290)
    save_smiles_splits: bool = False
    resume_from_checkpoint: Optional[str] = None  # fork addition (args.py:301-305)
    resume_experiment: bool = False
    checkpoint_frzn: Optional[str] = None
    frzn_encoder: bool = False  # fork: checkpoint_frzn alone only warm-starts;
    # the encoder is frozen only when this is set (run_training.py:277-288)
    freeze_first_only: bool = False
    frzn_ffn_layers: int = 0
    checkpoint_paths: Optional[List[str]] = None

    # model
    ensemble_size: int = 1
    hidden_size: int = 300
    bias: bool = False
    depth: int = 3
    mpn_shared: bool = False
    dropout: float = 0.0
    activation: str = "ReLU"
    atom_messages: bool = False
    undirected: bool = False
    ffn_hidden_size: Optional[int] = None
    ffn_num_layers: int = 2
    features_only: bool = False
    aggregation: str = "mean"
    aggregation_norm: float = 100.0

    # training
    epochs: int = 30
    batch_size: int = 50
    warmup_epochs: float = 2.0
    init_lr: float = 1e-4
    max_lr: float = 1e-3
    final_lr: float = 1e-4
    grad_clip: Optional[float] = None
    class_balance: bool = False
    optimizer: str = "adam"                  # fork addition (args.py:403-405)
    scheduler: str = "noam"                  # fork addition (args.py:406-407)
    weight_decay: float = 0.0                # fork addition (args.py:408)
    target_weights: Optional[List[float]] = None
    data_weights_path: Optional[str] = None
    log_frequency: int = 10
    cache_cutoff: int = 10000
    empty_cache: bool = False  # clear the graph cache before each run
    num_workers: int = 8

    # spectra
    spectra_activation: str = "exp"
    spectra_target_floor: float = 1e-8
    spectra_phase_mask_path: Optional[str] = None
    alternative_loss_function: Optional[str] = None

    # where the model trains: "cuda" (the default; raises without a GPU)
    # or "cpu" (the plain PyTorch versions of the kernels)
    device: str = "cuda"

    # fields the JAX package's trainer adds for its devices, parallelism
    # and kernels: kept so a checkpoint's config reads back whole. The
    # port reads param_dtype ("float32", or "bfloat16" / "bf16" for linear
    # layers with bfloat16 operands and float32 accumulation),
    # band_precision (the undirected layer's product: "high", "default" or
    # "highest", models/encoder.py), reference_init (None or True:
    # replay the reference's torch init stream) and use_native_featurizer
    # (None = auto = the C++ featurizer of native_ext.py, bit for bit the
    # Python path; --no_use_native_featurizer takes the Python path).
    num_devices: Optional[int] = None
    param_dtype: str = "float32"
    band_precision: str = "high"
    data_parallel: Optional[bool] = None
    reference_init: Optional[bool] = None
    graph_parallel: Optional[bool] = None
    graph_parallel_dp: int = 1
    graph_parallel_overlap: bool = True
    use_pallas: Optional[bool] = None
    use_native_featurizer: Optional[bool] = None
    profile_dir: Optional[str] = None
    tensorboard: bool = False
    # the torch.distributed backend of a torchrun launch: None picks
    # "nccl" when every rank has a card of its own, else "gloo"
    # (parallel/multihost.py pick_backend)
    dist_backend: Optional[str] = None

    def __post_init__(self):
        if self.metric is None:
            self.metric = {
                "regression": "rmse",
                "classification": "auc",
                "multiclass": "cross_entropy",
                "spectra": "sid",
            }[self.dataset_type]
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = self.hidden_size
        if self.atom_messages and self.undirected:
            raise ValueError(
                "Undirected is unnecessary when using atom_messages since "
                "atom_messages are by their nature undirected. "
                "(reference args.py:588-590)")
        self._validate_metrics()

    # -- derived ------------------------------------------------------------
    @property
    def metrics(self) -> List[str]:
        return [self.metric] + list(self.extra_metrics)

    @property
    def minimize_score(self) -> bool:
        from .train.metrics import minimize_score
        return minimize_score(self.metric)

    def _validate_metrics(self) -> None:
        """(reference args.py:563-573 validity matrix)."""
        valid = {
            "regression": {"rmse", "mae", "mse", "r2"},
            "classification": {"auc", "prc-auc", "accuracy",
                               "binary_cross_entropy"},
            "multiclass": {"cross_entropy", "accuracy"},
            "spectra": {"sid", "wasserstein"},
        }[self.dataset_type]
        for m in self.metrics:
            if m not in valid:
                raise ValueError(
                    f'Metric "{m}" invalid for dataset type '
                    f'"{self.dataset_type}".')

    def featurization(self) -> FeaturizationConfig:
        if self.reaction:
            return FeaturizationConfig.for_reaction(
                self.reaction_mode, explicit_h=self.explicit_h,
                adding_h=self.adding_h)
        return FeaturizationConfig(
            polymer=self.polymer, explicit_h=self.explicit_h,
            adding_h=self.adding_h,
            overwrite_default_atom_features=self.overwrite_default_atom_features,
            overwrite_default_bond_features=self.overwrite_default_bond_features)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["split_sizes"] = list(d["split_sizes"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if "split_sizes" in kwargs and kwargs["split_sizes"] is not None:
            kwargs["split_sizes"] = tuple(kwargs["split_sizes"])
        return cls(**kwargs)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "TrainConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


@dataclasses.dataclass
class PredictConfig:
    """(reference PredictArgs, args.py:653-688)."""

    test_path: str = ""
    preds_path: str = ""
    checkpoint_dir: Optional[str] = None
    checkpoint_path: Optional[str] = None
    checkpoint_paths: Optional[List[str]] = None
    smiles_columns: Optional[List[str]] = None
    number_of_molecules: int = 1
    features_generator: Optional[List[str]] = None
    features_path: Optional[List[str]] = None
    batch_size: int = 50
    num_workers: int = 8
    drop_extra_columns: bool = False
    ensemble_variance: bool = False
    individual_ensemble_predictions: bool = False
    # extra atom/bond feature inputs (reference CommonArgs args.py:97-102;
    # must match the descriptors the checkpoint was trained with)
    atom_descriptors: Optional[str] = None
    atom_descriptors_path: Optional[str] = None
    bond_features_path: Optional[str] = None
    phase_features_path: Optional[str] = None
    no_features_scaling: bool = False
    # fork additions (args.py:666-669)
    save_graph_embeddings: bool = False
    graph_embeddings_path: Optional[str] = None
    # where the model runs: "cuda" (the default; raises without a GPU) or
    # "cpu" (the plain PyTorch versions of the kernels)
    device: str = "cuda"
    # None = auto = the C++ featurizer (native_ext.py);
    # --no_use_native_featurizer takes the Python path
    use_native_featurizer: Optional[bool] = None


def find_checkpoints(checkpoint_dir: Optional[str] = None,
                     checkpoint_path: Optional[str] = None,
                     checkpoint_paths: Optional[List[str]] = None,
                     ext: str = ".ckpt") -> List[str]:
    """Checkpoint discovery by directory walk (reference args.py:19-59):
    native ``.ckpt`` files first; else ``best_model_full.pt`` alone where
    the directory has one (the only reference shape with args and
    scalers, reference run_training.py:424-435); else every ``.pt``."""
    provided = sum(x is not None for x in
                   (checkpoint_dir, checkpoint_path, checkpoint_paths))
    if provided > 1:
        raise ValueError("Can only specify one of checkpoint_dir, "
                         "checkpoint_path, and checkpoint_paths")
    if checkpoint_path is not None:
        return [checkpoint_path]
    if checkpoint_paths is not None:
        return checkpoint_paths
    if checkpoint_dir is not None:
        native, torch_pt = [], []
        for root, _, files in os.walk(checkpoint_dir):
            for fname in files:
                if fname.endswith(ext):
                    native.append(os.path.join(root, fname))
                elif fname.endswith(".pt"):
                    torch_pt.append(os.path.join(root, fname))
        found = native
        if not found:
            best = [p for p in torch_pt
                    if os.path.basename(p) == "best_model_full.pt"]
            found = best or torch_pt
        if len(found) == 0:
            raise ValueError(f'Failed to find any checkpoints with extension '
                             f'"{ext}" or ".pt" in directory '
                             f'"{checkpoint_dir}"')
        return sorted(found)
    return []


# ---------------------------------------------------------------------------
# CLI builders
# ---------------------------------------------------------------------------

def _add_field_args(parser: argparse.ArgumentParser, cls) -> None:
    """Auto-generate flags from dataclass fields."""
    for f in dataclasses.fields(cls):
        name = "--" + f.name
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            default = f.default_factory()  # type: ignore[misc]
        ftype = f.type if isinstance(f.type, str) else str(f.type)
        if "Optional[bool]" in ftype:
            # tri-state: --flag -> True, --no_flag -> False, absent -> None
            # (None = auto-resolve at runtime)
            parser.add_argument(name, dest=f.name, action="store_true",
                                default=default)
            parser.add_argument("--no_" + f.name, dest=f.name,
                                action="store_false")
        elif "bool" in ftype:
            if default:
                parser.add_argument("--no_" + f.name, dest=f.name,
                                    action="store_false", default=True)
            else:
                parser.add_argument(name, action="store_true", default=False)
        elif "List" in ftype:
            inner = float if "float" in ftype else (int if "int" in ftype else str)
            parser.add_argument(name, nargs="*", type=inner, default=default)
        elif "Tuple" in ftype:
            parser.add_argument(name, nargs=3, type=float, default=default)
        elif "int" in ftype:
            parser.add_argument(name, type=int, default=default)
        elif "float" in ftype:
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def parse_train_args(argv: Optional[List[str]] = None) -> TrainConfig:
    parser = argparse.ArgumentParser(
        prog="polymer_chemprop_tpu_torch train",
        description="Train a wD-MPNN property prediction model.")
    _add_field_args(parser, TrainConfig)
    parser.add_argument("--config_path", type=str, default=None,
                        help="JSON config overriding CLI flags "
                             "(reference args.py:537-542 semantics)")
    ns = parser.parse_args(argv)
    d = vars(ns)
    config_path = d.pop("config_path", None)
    if d.get("split_sizes") is not None:
        d["split_sizes"] = tuple(d["split_sizes"])
    if config_path is not None:
        with open(config_path) as f:
            d.update(json.load(f))  # config file overrides CLI (reference quirk)
    return TrainConfig.from_dict(d)


def parse_predict_args(argv: Optional[List[str]] = None) -> PredictConfig:
    parser = argparse.ArgumentParser(
        prog="polymer_chemprop_tpu_torch predict",
        description="Predict with trained checkpoints.")
    _add_field_args(parser, PredictConfig)
    ns = parser.parse_args(argv)
    known = {f.name for f in dataclasses.fields(PredictConfig)}
    return PredictConfig(**{k: v for k, v in vars(ns).items() if k in known})
