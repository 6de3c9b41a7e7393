"""Checkpoint-ensemble prediction (reference train/make_predictions.py:17-308).

The port's counterpart of polymer_chemprop_tpu train/make_predictions.py:
read each JAX-format ``.ckpt``, featurize the input with the checkpoint's
featurization config, batch with the dst-sorted bond layout, run the model
on ``args.device`` (CUDA unless the caller asks for the CPU), average the
ensemble, optionally report its variance or individual predictions, and
write a CSV that keeps every input row ('Invalid SMILES' placeholders for
rows that do not parse).
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional

import numpy as np

from ..config import PredictConfig, TrainConfig, find_checkpoints
from ..data import (MoleculeDataLoader, get_data, get_data_from_smiles,
                    get_task_names, partition_valid)
from ..models.convert import load_jax_params
from ..models.model import MoleculeModel, build_model_config
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


def check_prediction_args(args: PredictConfig, tcfg: TrainConfig) -> None:
    """Raise for the inputs the port does not support yet: molecule-level
    extra features and per-atom/bond descriptor files."""
    extras = {
        "features_generator": tcfg.features_generator or args.features_generator,
        "features_path": tcfg.features_path or args.features_path,
        "phase_features_path": tcfg.phase_features_path
        or args.phase_features_path,
        "atom_descriptors": tcfg.atom_descriptors or args.atom_descriptors,
        "atom_descriptors_path": tcfg.atom_descriptors_path
        or args.atom_descriptors_path,
        "bond_features_path": tcfg.bond_features_path
        or args.bond_features_path,
    }
    used = [k for k, v in extras.items() if v]
    if used:
        raise NotImplementedError(
            f"not on the port yet: extra feature inputs ({', '.join(used)})")


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
    check_prediction_args(args, tcfg)

    # every input row appears in the output CSV (reference
    # make_predictions.py:66-73, 216-221)
    if smiles is not None:
        full_data = get_data_from_smiles(smiles, fcfg,
                                         skip_invalid_smiles=False)
        full_rows = [{"smiles": ".".join(s)} for s in smiles]
    else:
        full_data = get_data(args.test_path, args.smiles_columns,
                             target_columns=[],
                             number_of_molecules=args.number_of_molecules,
                             config=fcfg, skip_invalid_smiles=False,
                             store_row=True)
        full_rows = [d.row for d in full_data]
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

    model_cfg = build_model_config(tcfg, num_tasks)
    loader = MoleculeDataLoader(test_data, fcfg, batch_size=args.batch_size,
                                num_workers=args.num_workers,
                                use_native=args.use_native_featurizer)
    model = MoleculeModel(model_cfg).to(device)

    sum_preds = sq_preds = sum_emb = None
    individual = []
    for ckpt in ckpts:
        params, _, scalers = load_model(ckpt)
        load_jax_params(model, params)
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
