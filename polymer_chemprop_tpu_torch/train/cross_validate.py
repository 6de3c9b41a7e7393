"""Top-level cross-validation orchestration
(reference train/cross_validate.py:22-193); the port's counterpart of
polymer_chemprop_tpu train/cross_validate.py."""

from __future__ import annotations

import csv
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import TrainConfig
from ..data import get_data, get_task_names
from ..utils.logging import get_logger, timeit
from .trainer import run_training

TEST_SCORES_FILE_NAME = "test_scores.csv"


def cross_validate(cfg: TrainConfig,
                   train_func: Callable = run_training
                   ) -> Tuple[float, float]:
    """k-fold cross-validation; returns (mean, std) of the main metric
    (reference cross_validate.py:22-184)."""
    from ..parallel.mesh import world
    # several ranks (torchrun): rank 0 keeps the logs and writes the files
    main = world()[0] == 0
    logger = get_logger("train", cfg.save_dir if main else None,
                        cfg.quiet or not main)
    info = logger.info
    init_seed = cfg.seed
    save_dir = cfg.save_dir
    fcfg = cfg.featurization()

    task_names = get_task_names(cfg.data_path, cfg.smiles_columns,
                                cfg.target_columns, cfg.ignore_columns,
                                cfg.number_of_molecules)
    if save_dir and main:
        os.makedirs(save_dir, exist_ok=True)
        cfg.save(os.path.join(save_dir, "args.json"))

    if cfg.empty_cache:
        from ..data import empty_cache
        empty_cache()

    info("Loading data")
    data = get_data(cfg.data_path, cfg.smiles_columns, cfg.target_columns,
                    cfg.ignore_columns, cfg.number_of_molecules, fcfg,
                    features_path=cfg.features_path,
                    features_generators=cfg.features_generator,
                    data_weights_path=cfg.data_weights_path,
                    max_data_size=cfg.max_data_size,
                    atom_descriptors=cfg.atom_descriptors,
                    atom_descriptors_path=cfg.atom_descriptors_path,
                    bond_features_path=cfg.bond_features_path,
                    phase_features_path=cfg.phase_features_path)

    all_scores: Dict[str, List[List[float]]] = {}
    for fold_num in range(cfg.num_folds):
        info(f"Fold {fold_num}")
        # undo the previous fold's in-place target/feature normalization
        # (reference cross_validate.py:105)
        data.reset_features_and_targets()
        fold_cfg = type(cfg).from_dict(cfg.to_dict())
        fold_cfg.seed = init_seed + fold_num
        fold_cfg.save_dir = os.path.join(save_dir, f"fold_{fold_num}") \
            if save_dir else None
        if fold_cfg.save_dir and main:
            os.makedirs(fold_cfg.save_dir, exist_ok=True)

        # fold-resume (fork addition, reference cross_validate.py:108-115)
        scores_json = os.path.join(fold_cfg.save_dir, "test_scores.json") \
            if fold_cfg.save_dir else None
        if cfg.resume_experiment and scores_json and os.path.exists(scores_json):
            info(f"Fold {fold_num} already trained, loading scores")
            with open(scores_json) as f:
                model_scores = json.load(f)
        else:
            model_scores = train_func(fold_cfg, data, logger)
        for metric, scores in model_scores.items():
            all_scores.setdefault(metric, []).append(scores)

    info(f"{cfg.num_folds}-fold cross validation")
    for fold_num in range(cfg.num_folds):
        for metric, scores in all_scores.items():
            info(f"\tSeed {init_seed + fold_num} ==> test {metric} = "
                 f"{np.nanmean(scores[fold_num]):.6f}")
            if cfg.show_individual_scores:
                for name, score in zip(task_names, scores[fold_num]):
                    info(f"\t\tSeed {init_seed + fold_num} ==> test "
                         f"{name} {metric} = {score:.6f}")

    mean_score = std_score = float("nan")
    for metric, scores in all_scores.items():
        avg = np.nanmean(np.asarray(scores, dtype=float), axis=1)
        mean, std = float(np.nanmean(avg)), float(np.nanstd(avg))
        info(f"Overall test {metric} = {mean:.6f} +/- {std:.6f}")
        if cfg.show_individual_scores:
            arr = np.asarray(scores, dtype=float)
            for t_idx, name in enumerate(task_names):
                if t_idx < arr.shape[1]:
                    info(f"\tOverall test {name} {metric} = "
                         f"{np.nanmean(arr[:, t_idx]):.6f} +/- "
                         f"{np.nanstd(arr[:, t_idx]):.6f}")
        if metric == cfg.metric:
            mean_score, std_score = mean, std

    if save_dir and main:
        # spectra evaluates one score across the whole spectrum, not per task
        n_scored = len(all_scores[cfg.metric][0])
        if n_scored != len(task_names):
            task_names = ["spectra"] if cfg.dataset_type == "spectra" \
                else [f"task_{i}" for i in range(n_scored)]
        with open(os.path.join(save_dir, TEST_SCORES_FILE_NAME), "w",
                  newline="") as f:
            writer = csv.writer(f)
            header = ["Task"]
            for metric in cfg.metrics:
                header += [f"Mean {metric}", f"Standard deviation {metric}"] \
                    + [f"Fold {i} {metric}" for i in range(cfg.num_folds)]
            writer.writerow(header)
            for t_idx, name in enumerate(task_names):
                row = [name]
                for metric in cfg.metrics:
                    vals = [all_scores[metric][f][t_idx]
                            for f in range(cfg.num_folds)]
                    row += [np.nanmean(vals), np.nanstd(vals)] + vals
                writer.writerow(row)

    return mean_score, std_score


@timeit()
def chemprop_train(argv: Optional[List[str]] = None) -> Tuple[float, float]:
    """CLI entry (reference cross_validate.py:187-193); under ``torchrun``
    each rank runs it (parallel/multihost.py ``initialize_multihost``)."""
    from ..config import parse_train_args
    from ..parallel.multihost import initialize_multihost
    cfg = parse_train_args(argv)
    # under torchrun (WORLD_SIZE > 1) every rank starts the process group
    started = initialize_multihost(backend=cfg.dist_backend,
                                   device=cfg.device)
    try:
        return cross_validate(cfg)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()
