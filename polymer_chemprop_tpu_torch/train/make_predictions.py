"""Checkpoint-ensemble prediction (reference train/make_predictions.py:17-308).

The port's counterpart of polymer_chemprop_tpu train/make_predictions.py:
read each JAX-format ``.ckpt``, featurize the input with the checkpoint's
featurization config and the extra inputs it was trained with (features
generators inherited from the checkpoint; feature, phase, atom descriptor
and bond feature files given again), re-apply each member's feature
scalers, batch with the dst-sorted bond layout, run the model on
``args.device`` (CUDA unless the caller asks for the CPU) with one encoder
per molecule position (:func:`serving_model`), average the
ensemble, optionally report its variance or individual predictions, and
write a CSV that keeps every input row ('Invalid SMILES' placeholders for
rows that do not parse).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import List, Optional

import numpy as np

from ..config import PredictConfig, TrainConfig, find_checkpoints
from ..data import (MoleculeDataLoader, get_data, get_data_from_smiles,
                    get_task_names, partition_valid)
from ..models.convert import load_jax_params
from ..models.model import MoleculeModel, ModelConfig, build_model_config
from ..utils.checkpoint import load_checkpoint
from .predict import predict, resolve_device


def load_model(ckpt_path: str):
    """Params (JAX layout, numpy), TrainConfig and scalers of one
    checkpoint."""
    params, config_dict, scalers, _ = load_checkpoint(ckpt_path)
    if config_dict is None:
        raise ValueError(
            f"{ckpt_path} is a weights-only checkpoint (no training args); "
            "prediction needs a full checkpoint")
    return params, TrainConfig.from_dict(config_dict), scalers


def serving_model(model_cfg: ModelConfig) -> MoleculeModel:
    """The model that serves checkpoints: one encoder per molecule
    position, also where training shared one (``mpn_shared``). The JAX
    package trains each position's copy of a shared encoder on its own
    gradient, so its files can hold copies that differ; this model applies
    copy i to position i as the JAX package does, and equal copies give
    the shared model's function exactly. Every member of an ensemble loads
    into it."""
    return MoleculeModel(dataclasses.replace(model_cfg, mpn_shared=False))


def update_prediction_args(args: PredictConfig, tcfg: TrainConfig) -> None:
    """Reconcile predict-time args with the training configuration
    (reference utils.py:731-807, JAX make_predictions.py:52-90): extra
    inputs given at training must be given again, and none may be given
    that training did not use; a features generator is inherited from the
    checkpoint."""
    if tcfg.features_path and not args.features_path \
            and not args.features_generator:
        raise ValueError(
            "Features were used during training so they must be specified "
            "again during prediction using --features_path.")
    if tcfg.features_generator and not args.features_generator:
        args.features_generator = tcfg.features_generator
    if args.features_generator and not (tcfg.features_generator
                                        or tcfg.features_path):
        raise ValueError(
            "Features were not used during training, so they cannot be "
            "specified during prediction.")
    # extra atom/bond feature consistency (reference utils.py:769-807)
    if tcfg.atom_descriptors_path and not args.atom_descriptors_path:
        raise ValueError(
            "Atom descriptors were used during training so they must be "
            "specified again during prediction using "
            "--atom_descriptors_path.")
    if args.atom_descriptors_path and not tcfg.atom_descriptors_path:
        raise ValueError(
            "Atom descriptors were not used during training, so they "
            "cannot be specified during prediction.")
    if tcfg.bond_features_path and not args.bond_features_path:
        raise ValueError(
            "Bond features were used during training so they must be "
            "specified again during prediction using "
            "--bond_features_path.")
    if args.bond_features_path and not tcfg.bond_features_path:
        raise ValueError(
            "Bond features were not used during training, so they cannot "
            "be specified during prediction.")


def load_prediction_data(args: PredictConfig, tcfg: TrainConfig, fcfg,
                         smiles: Optional[List[List[str]]] = None):
    """Every input row (invalid ones included) with the extra inputs the
    checkpoint was trained with -> ``(full_data, full_rows)``."""
    if smiles is not None:
        full_data = get_data_from_smiles(
            smiles, fcfg, skip_invalid_smiles=False,
            features_generators=tcfg.features_generator)
        return full_data, [{"smiles": ".".join(s)} for s in smiles]
    full_data = get_data(
        args.test_path, args.smiles_columns, target_columns=[],
        number_of_molecules=args.number_of_molecules, config=fcfg,
        skip_invalid_smiles=False, features_path=args.features_path,
        features_generators=args.features_generator
        or tcfg.features_generator,
        atom_descriptors=args.atom_descriptors or tcfg.atom_descriptors,
        atom_descriptors_path=args.atom_descriptors_path,
        bond_features_path=args.bond_features_path,
        phase_features_path=args.phase_features_path
        or tcfg.phase_features_path,
        store_row=True)
    return full_data, [d.row for d in full_data]


def apply_scalers(data, scalers) -> None:
    """Re-apply one ensemble member's training-time feature scalers to the
    raw features (reference make_predictions.py:146-153): the molecule
    features, atom descriptor and bond feature scalers that its checkpoint
    carries. A scaler is saved only when its scaling was on, so each is
    applied when present."""
    keys = ("features_scaler", "atom_descriptor_scaler",
            "bond_feature_scaler")
    if all(scalers.get(k) is None for k in keys):
        return
    data.reset_features_and_targets()
    if data.features() is not None and \
            scalers.get("features_scaler") is not None:
        data.normalize_features(scalers["features_scaler"])
    if scalers.get("atom_descriptor_scaler") is not None:
        data.normalize_features(scalers["atom_descriptor_scaler"],
                                scale_atom_descriptors=True)
    if scalers.get("bond_feature_scaler") is not None:
        data.normalize_features(scalers["bond_feature_scaler"],
                                scale_bond_features=True)


def make_predictions(args: PredictConfig,
                     smiles: Optional[List[List[str]]] = None,
                     return_index_map: bool = False) -> List[List]:
    """(reference make_predictions.py:271-300).

    Returns predictions for the VALID input rows only (reference
    semantics); with ``return_index_map=True`` additionally returns the
    full->valid index dict."""
    device = resolve_device(args.device)
    ckpts = find_checkpoints(args.checkpoint_dir, args.checkpoint_path,
                             args.checkpoint_paths)
    # prefer best_model checkpoints when a directory was walked
    best = [c for c in ckpts if os.path.basename(c) == "best_model.ckpt"]
    if best:
        ckpts = best
    if not ckpts:
        raise ValueError("No checkpoints given or found.")

    _, tcfg, _ = load_model(ckpts[0])
    fcfg = tcfg.featurization()
    update_prediction_args(args, tcfg)

    # every input row appears in the output CSV (reference
    # make_predictions.py:66-73, 216-221)
    full_data, full_rows = load_prediction_data(args, tcfg, fcfg, smiles)
    full_to_valid, test_data = partition_valid(full_data, fcfg)
    if len(test_data) < len(full_data):
        print(f"Warning: {len(full_data) - len(test_data)} SMILES are "
              "invalid; their rows get 'Invalid SMILES' predictions.")

    num_tasks = _num_tasks(tcfg)
    if len(test_data) == 0:
        if args.preds_path:
            _write_preds(args, tcfg, full_rows, np.zeros((0, num_tasks)),
                         None, [], num_tasks, {})
        result = [None] * len(full_data)
        return (result, {}) if return_index_map else result

    model_cfg = build_model_config(tcfg, num_tasks, data=test_data)
    loader = MoleculeDataLoader(test_data, fcfg, batch_size=args.batch_size,
                                num_workers=args.num_workers,
                                use_native=args.use_native_featurizer)
    model = serving_model(model_cfg).to(device)

    sum_preds = sq_preds = sum_emb = None
    individual = []
    for ckpt in ckpts:
        params, _, scalers = load_model(ckpt)
        load_jax_params(model, params)
        apply_scalers(test_data, scalers)
        preds, emb = predict(model, loader, device,
                             scaler=scalers.get("data_scaler"),
                             return_embeddings=args.save_graph_embeddings)
        arr = np.array(preds, dtype=float)
        sum_preds = arr if sum_preds is None else sum_preds + arr
        if args.ensemble_variance:
            sq_preds = arr ** 2 if sq_preds is None else sq_preds + arr ** 2
        if args.individual_ensemble_predictions or \
                (args.ensemble_variance and tcfg.dataset_type == "spectra"):
            individual.append(arr)
        if emb is not None:
            sum_emb = emb if sum_emb is None else sum_emb + emb

    n = len(ckpts)
    avg_preds = sum_preds / n
    var_preds = (sq_preds / n - avg_preds ** 2) if sq_preds is not None else None
    if args.ensemble_variance and tcfg.dataset_type == "spectra" and individual:
        # spectra ensembles report round-robin pairwise SID instead of
        # variance (reference make_predictions.py:198-199)
        from .metrics import roundrobin_sid
        stacked = np.stack(individual, axis=2)  # (N, L, ensemble)
        rr = roundrobin_sid(stacked, threshold=tcfg.spectra_target_floor)
        var_preds = np.asarray(rr)[:, None].repeat(avg_preds.shape[1], axis=1)
    if sum_emb is not None and args.graph_embeddings_path:
        np.save(args.graph_embeddings_path, sum_emb / n)

    if args.preds_path:
        _write_preds(args, tcfg, full_rows, avg_preds, var_preds,
                     individual if args.individual_ensemble_predictions else [],
                     num_tasks, full_to_valid)
    result = avg_preds.tolist()
    return (result, full_to_valid) if return_index_map else result


def _num_tasks(tcfg: TrainConfig) -> int:
    if tcfg.target_columns:
        return len(tcfg.target_columns)
    try:
        return len(get_task_names(tcfg.data_path, tcfg.smiles_columns,
                                  tcfg.target_columns, tcfg.ignore_columns,
                                  tcfg.number_of_molecules))
    except (OSError, ValueError):
        return 1


def _write_preds(args: PredictConfig, tcfg: TrainConfig, rows, avg_preds,
                 var_preds, individual, num_tasks, full_to_valid) -> None:
    os.makedirs(os.path.dirname(args.preds_path) or ".", exist_ok=True)
    task_names = tcfg.target_columns or [f"task_{i}" for i in range(num_tasks)]
    multiclass = tcfg.dataset_type == "multiclass"
    with open(args.preds_path, "w", newline="") as f:
        base_cols = list(rows[0].keys()) if rows and rows[0] else ["smiles"]
        if args.drop_extra_columns:
            # keep only the SMILES column(s) (reference PredictArgs flag)
            keep = tcfg.smiles_columns or base_cols[:tcfg.number_of_molecules]
            base_cols = [c for c in base_cols if c in keep] or base_cols[:1]
        # spectra ensembles report ONE round-robin-SID column, not
        # per-task variances (reference make_predictions.py:249-253)
        spectra_unc = var_preds is not None and tcfg.dataset_type == "spectra"
        header = list(base_cols) + list(task_names)
        if spectra_unc:
            header += ["epi_unc"]
        elif var_preds is not None:
            header += [f"{t}_epi_unc" for t in task_names]
        for i in range(len(individual)):
            header += [f"{t}_model_{i}" for t in task_names]
        w = csv.writer(f)
        w.writerow(header)
        for i, row in enumerate(rows):
            if row and args.drop_extra_columns:
                vals = [row[c] for c in base_cols if c in row]
            else:
                vals = list(row.values()) if row else [""]
            v = full_to_valid.get(i)
            if v is None:
                # unparseable input row: preserved with placeholders
                # (reference make_predictions.py:216-221)
                n_pred = len(header) - len(base_cols)
                w.writerow(vals + ["Invalid SMILES"] * n_pred)
                continue
            if multiclass:
                preds_row = [list(np.argmax(avg_preds[v], axis=-1))] \
                    if avg_preds.ndim == 3 else list(avg_preds[v])
            else:
                preds_row = list(avg_preds[v])
            out = vals + preds_row
            if spectra_unc:
                out += [var_preds[v][0]]
            elif var_preds is not None:
                out += list(var_preds[v])
            for ind in individual:
                out += list(ind[v])
            w.writerow(out)


def chemprop_predict(argv: Optional[List[str]] = None) -> None:
    """CLI entry (reference make_predictions.py:303-308)."""
    from ..config import parse_predict_args
    make_predictions(parse_predict_args(argv))
