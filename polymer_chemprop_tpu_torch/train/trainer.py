"""Per-fold training orchestration (reference train/run_training.py:28-499).

The port's counterpart of polymer_chemprop_tpu train/trainer.py on one
device: split -> feature scaling (molecule features, atom descriptors, bond
features) -> target scaling (regression) or spectra normalization with
phase masks -> loaders -> per-ensemble-member init (or warm start, or
resume) -> epoch loop (train epoch, eval val, per-epoch CSV logging,
every-epoch resume checkpoint, best-model tracking) -> best-model test
evaluation -> ensemble-averaged test predictions. The four scalers go into
every checkpoint under the JAX package's keys. With ``tensorboard`` each
member writes four scalars an epoch into its model directory; with
``profile_dir`` the first epoch of member 0 runs under
``torch.profiler`` and leaves a Chrome trace there.

The model trains on ``cfg.device``: CUDA unless the caller asks for the
CPU. Under ``torchrun`` (a process group of several ranks, cli.py) it
trains data-parallel (``data_parallel``; on by default for several ranks
on CUDA) or graph-parallel (``graph_parallel``: each batch's bonds
edge-partitioned over the ranks, ``graph_parallel_dp`` replicas of that
on a 2-D mesh; on by default above the bond envelope of 57,344), as the
JAX trainer does (its trainer.py:308-386, 510-700; parallel/). Every
rank trains the same model on its share; evaluation, logs and
checkpoints are rank 0's. Checkpoints are the JAX package's ``.ckpt``
(utils/checkpoint.py), optimizer state included, so either package
resumes and predicts from the other's files.
"""

from __future__ import annotations

import csv
import json
import math
import os
import time
from random import Random
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainConfig
from ..data import (
    MoleculeDataLoader,
    MoleculeDataset,
    get_data,
    get_task_names,
    set_cache_graph,
    split_data,
)
from ..models.convert import (
    check_shared_copies,
    load_jax_params,
    opt_state_from_leaves,
    opt_state_to_leaves,
    params_to_jax,
)
from ..models.init import init_model, reference_init_model
from ..models.model import (
    MoleculeModel,
    build_model_config,
    widened_featurization,
)
from ..models.nn import compute_pnorm, param_count
from ..parallel.dp import make_dp_train_step
from ..parallel.mesh import make_mesh, world
from ..parallel.multihost import rank_device
from ..parallel.partition import (build_edge_shards_halo_dp,
                                  flat_all_reduce, make_halo_dp_train_step)
from ..utils.checkpoint import load_checkpoint, load_opt_leaves, save_checkpoint
from ..utils.logging import get_logger
from .evaluate import evaluate
from .metrics import evaluate_predictions
from .predict import predict, resolve_device
from .scheduler import build_optimizer, build_schedule
from .step import TrainStep, batch_pytree, batch_tensors, make_loss_fn


def _start_profile(device: torch.device):
    """A running ``torch.profiler``: host and CUDA activity on a
    card, the host alone on the CPU."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, device: torch.device, profile_dir: str,
                  model_dir) -> str:
    """Stop after the device has finished the epoch's work (JAX
    trainer.py:714-718 blocks on the parameters) and write the Chrome
    trace into ``profile_dir``; returns its path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    tag = os.path.basename(os.path.dirname(model_dir)) if model_dir else "run"
    path = os.path.join(profile_dir, f"trace_{tag}.json")
    prof.export_chrome_trace(path)
    return path


def _trainable_mask(model: MoleculeModel, cfg: TrainConfig) -> Dict[str, bool]:
    """Parameter-freezing mask by parameter name for transfer learning
    (reference model.py:49-55, 118-121: freeze encoders and/or first FFN
    layers). checkpoint_frzn alone only warm-starts; the encoder is frozen
    only when frzn_encoder is set (reference run_training.py:277-288)."""
    mask = {name: True for name, _ in model.named_parameters()}
    if cfg.checkpoint_frzn is None:
        return mask
    frozen = []
    if cfg.frzn_encoder:
        n_enc = 1 if cfg.freeze_first_only else len(model.encoders)
        frozen += [f"encoders.{i}." for i in range(n_enc)]
    frozen += [f"ffn.{j}." for j in range(max(cfg.frzn_ffn_layers, 0))]
    for name in mask:
        if name.startswith(tuple(frozen)):
            mask[name] = False
    return mask


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count_leaves(v) for v in tree)
    return 1


def _merge_matching(params, loaded):
    """Shape-checked partial parameter load (reference utils.py:116-130)
    over JAX-layout pytrees: take every leaf from ``loaded`` whose path and
    shape match ``params``; keep the fresh initialization elsewhere.
    Returns (merged, used, skipped)."""
    used = skipped = 0

    def skip(leaf):
        nonlocal skipped
        skipped += _count_leaves(leaf)
        return leaf

    def merge(dst, src):
        nonlocal used, skipped
        if isinstance(dst, dict):
            return {k: merge(dst[k], src[k]) if isinstance(src, dict)
                    and k in src else skip(dst[k]) for k in dst}
        if isinstance(dst, list):
            src_l = src if isinstance(src, list) else []
            return [merge(d, src_l[i]) if i < len(src_l) else skip(d)
                    for i, d in enumerate(dst)]
        if src is not None and not isinstance(src, (dict, list)) \
                and np.shape(src) == np.shape(dst):
            used += 1
            return np.asarray(src)
        skipped += 1
        return dst

    return merge(params, loaded), used, skipped


def _as_shared(params, cfg: TrainConfig):
    """A loaded JAX-layout pytree as a model with ``mpn_shared`` takes it:
    its first encoder at every molecule position, as the reference loads
    encoder 0 into its one shared module (so a one-molecule file starts
    every position). A tree whose copies differ, as the JAX package's
    training leaves them, raises (models/convert.py
    ``check_shared_copies``)."""
    if not cfg.mpn_shared or "encoders" not in params:
        return params
    check_shared_copies(params)
    return dict(params, encoders=params["encoders"][:1]
                * cfg.number_of_molecules)


def _load_frzn_into(params, frzn_path: str, cfg: TrainConfig):
    """Overwrite encoder (+ optionally first FFN layers) weights of a
    JAX-layout pytree from a pretrained checkpoint (reference
    utils.py:172-261 load_frzn_model)."""
    frzn_params = _as_shared(load_checkpoint(frzn_path)[0], cfg)

    def copy_matching(dst, src):
        if isinstance(dst, dict):
            return {k: copy_matching(dst[k], src[k]) if k in src else dst[k]
                    for k in dst}
        if isinstance(dst, list):
            return [copy_matching(d, s) for d, s in zip(dst, src)] \
                + dst[len(src):]
        if src is not None and np.shape(src) == np.shape(dst):
            return np.asarray(src)
        return dst

    out = dict(params)
    if "encoders" in frzn_params:
        out["encoders"] = copy_matching(params["encoders"],
                                        frzn_params["encoders"])
    if cfg.frzn_ffn_layers > 0 and "ffn" in frzn_params:
        n = cfg.frzn_ffn_layers
        out["ffn"] = [copy_matching(params["ffn"][i], frzn_params["ffn"][i])
                      if i < n else params["ffn"][i]
                      for i in range(len(params["ffn"]))]
    return out


def _split(cfg: TrainConfig, data: MoleculeDataset, fcfg):
    """(reference run_training.py:57-105); separate sets take their own
    feature, phase, atom descriptor and bond feature files (JAX
    trainer.py:205-232)."""
    if cfg.separate_val_path or cfg.separate_test_path:
        def separate(split):
            path = getattr(cfg, f"separate_{split}_path")
            if not path:
                return None
            return get_data(
                path, cfg.smiles_columns, cfg.target_columns,
                cfg.ignore_columns, cfg.number_of_molecules, fcfg,
                features_path=getattr(cfg, f"separate_{split}_features_path")
                or cfg.features_path,
                features_generators=cfg.features_generator,
                atom_descriptors=cfg.atom_descriptors,
                atom_descriptors_path=getattr(
                    cfg, f"separate_{split}_atom_descriptors_path"),
                bond_features_path=getattr(
                    cfg, f"separate_{split}_bond_features_path"),
                phase_features_path=getattr(
                    cfg, f"separate_{split}_phase_features_path"))
        val_data = separate("val")
        test_data = separate("test")
        split_args = (cfg.seed, cfg.num_folds, cfg.folds_file,
                      cfg.val_fold_index, cfg.test_fold_index)
        if val_data is not None and test_data is not None:
            train_data = data
        elif val_data is not None:
            train_data, _, test_data = split_data(
                data, cfg.split_type, (0.8, 0.0, 0.2), *split_args)
        else:
            train_data, val_data, _ = split_data(
                data, cfg.split_type, (0.8, 0.2, 0.0), *split_args)
        return train_data, val_data, test_data
    crossval_sets = None
    if cfg.crossval_index_file:
        import pickle
        with open(cfg.crossval_index_file, "rb") as f:
            crossval_sets = pickle.load(f)
    return split_data(
        data, cfg.split_type, cfg.split_sizes, cfg.seed, cfg.num_folds,
        cfg.folds_file, cfg.val_fold_index, cfg.test_fold_index,
        crossval_index_sets=crossval_sets,
        crossval_index_dir=cfg.crossval_index_dir)


GP_AUTO_BOND_ENVELOPE = 57344   # JAX trainer.py:366


def run_training(cfg: TrainConfig, data: MoleculeDataset,
                 logger=None) -> Dict[str, List[float]]:
    """Train one fold, return test scores per metric
    (reference run_training.py:28-499). With several ranks every rank
    calls it and all return rank 0's scores."""
    rank, n_dev = world()
    main = rank == 0
    device = rank_device(cfg.device) if n_dev > 1 \
        else resolve_device(cfg.device)
    log = logger or get_logger("train", cfg.save_dir if main else None,
                               cfg.quiet or not main)
    debug, info = log.debug, log.info
    # widened by the dataset's extra atom/bond features (reference
    # cross_validate.py:83-91)
    fcfg = widened_featurization(cfg, data)

    train_data, val_data, test_data = _split(cfg, data, fcfg)

    # train_frac subsampling (reference run_training.py:132-137)
    if cfg.train_frac < 1.0:
        n_keep = int(len(train_data) * cfg.train_frac)
        idx = list(range(len(train_data)))
        Random(cfg.seed).shuffle(idx)
        train_data = MoleculeDataset([train_data[i] for i in idx[:n_keep]])

    num_tasks = data.num_tasks or 0
    info(f"Total size = {len(data):,} | train size = {len(train_data):,} | "
         f"val size = {len(val_data):,} | test size = {len(test_data):,}")

    if cfg.save_smiles_splits and cfg.save_dir and main:
        from ..utils.splits_io import save_smiles_splits
        save_smiles_splits(cfg.save_dir, train_data, val_data, test_data,
                           data_path=cfg.data_path,
                           smiles_columns=cfg.smiles_columns)

    scalers = _scale_features(cfg, train_data, val_data, test_data)

    # target scaling (reference run_training.py:143-158)
    scaler = None
    if cfg.dataset_type == "regression":
        debug("Fitting scaler")
        scaler = train_data.normalize_targets()
    elif cfg.dataset_type == "spectra":
        debug("Normalizing spectra and excluding spectra regions based on "
              "phase")
        _normalize_spectra_targets(train_data, val_data, test_data, cfg)
    scalers["data_scaler"] = scaler

    # data parallelism over the ranks (JAX trainer.py:308-320): each step
    # takes one micro-batch of ceil(batch_size / ranks) a rank
    dp_enabled = cfg.data_parallel
    if dp_enabled is None:      # auto: on for several ranks on CUDA
        dp_enabled = device.type == "cuda" and n_dev > 1
    dp_enabled = bool(dp_enabled) and n_dev > 1
    train_batch_size = cfg.batch_size
    if dp_enabled:
        train_batch_size = max(1, math.ceil(cfg.batch_size / n_dev))

    # graph parallelism: edge-partitioned halo training (JAX
    # trainer.py:322-346). atom_messages and undirected are supported, as
    # in the JAX package's code (partition.py:793-831)
    gp_reasons = []
    if n_dev <= 1:
        gp_reasons.append("single device")
    if cfg.dataset_type not in ("regression", "classification",
                                "multiclass"):
        gp_reasons.append(f"dataset_type {cfg.dataset_type}")
    if cfg.features_only:
        gp_reasons.append("features_only (no message passing to shard)")
    gp_dp = max(1, int(cfg.graph_parallel_dp))
    if gp_dp > 1 and n_dev % gp_dp:
        gp_reasons.append(f"graph_parallel_dp {gp_dp} does not divide "
                          f"device count {n_dev}")
    gp_supported = not gp_reasons
    gp_enabled = cfg.graph_parallel
    if gp_enabled and not gp_supported:
        raise ValueError("--graph_parallel is unsupported for this run: "
                         + ", ".join(gp_reasons))
    if gp_enabled:
        dp_enabled = False
        train_batch_size = cfg.batch_size

    # loaders; the edge partitioner needs the natural (fwd, rev) bond pair
    # order (JAX trainer.py:353-357)
    set_cache_graph(len(data) <= cfg.cache_cutoff and not cfg.no_cache_mol)
    loader_kw = dict(batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                     use_native=cfg.use_native_featurizer)

    def make_train_loader(batch_size, gp):
        return MoleculeDataLoader(
            train_data, fcfg, shuffle=True, seed=cfg.seed,
            class_balance=cfg.class_balance, sorted_aux=not gp,
            **dict(loader_kw, batch_size=batch_size))

    train_loader = make_train_loader(train_batch_size, bool(gp_enabled))
    if gp_enabled is None:
        # auto: edge-partition above ~2x a chip's per-batch bond optimum
        # (JAX trainer.py:361-377)
        gp_enabled = (gp_supported and train_loader.estimated_pad_bonds()
                      > GP_AUTO_BOND_ENVELOPE)
        if gp_enabled:
            dp_enabled = False
            train_loader = make_train_loader(cfg.batch_size, True)
    gp_enabled = bool(gp_enabled)
    if gp_enabled:
        info(f"Graph-parallel training: edge-partitioned halo exchange "
             f"over {n_dev} devices"
             + (f" ({gp_dp} dp x {n_dev // gp_dp} ep)" if gp_dp > 1
                else ""))
    elif dp_enabled:
        info(f"Data-parallel training over {n_dev} devices "
             f"(micro-batch {train_batch_size})")
    val_loader = MoleculeDataLoader(val_data, fcfg, **loader_kw)
    test_loader = MoleculeDataLoader(test_data, fcfg, **loader_kw)
    # unshuffled train loader for per-epoch train-set evaluation
    train_eval_loader = MoleculeDataLoader(train_data, fcfg, **loader_kw)

    model_cfg = build_model_config(cfg, num_tasks, data=train_data)
    save_dir = cfg.save_dir
    # reference quirk kept for parity: the Noam horizon is built with
    # steps_per_epoch = train_size // batch_size (FLOOR) although the
    # trainer steps once per actual batch (ceil), so with a ragged last
    # batch the rate decays slightly faster than the nominal horizon. A
    # data-parallel step takes a whole batch too, so the horizon stays
    # (the JAX trainer divides it by the device count, trainer.py:413-414,
    # which decays its rate that much faster: ROADMAP.md §3); a 2-D
    # graph-parallel step takes gp_dp batches
    steps_per_epoch = max(1, len(train_data) // cfg.batch_size)
    if gp_enabled and gp_dp > 1:
        steps_per_epoch = max(1, math.ceil(steps_per_epoch / gp_dp))
    if dp_enabled:
        dp_mesh = make_mesh(n_dev, ("dp",))
    if gp_enabled:
        gp_n_ep = n_dev // gp_dp
        gp_mesh = make_mesh(n_dev, ("dp", "ep"), shape=(gp_dp, gp_n_ep))
        gp_fallback_warned = False
        gp_batches = [0, 0]     # loader batches: all, and fallen back

    try:
        task_names = get_task_names(
            cfg.data_path, cfg.smiles_columns, cfg.target_columns,
            cfg.ignore_columns, cfg.number_of_molecules)
    except (OSError, ValueError):
        task_names = []
    if len(task_names) != num_tasks:
        task_names = [f"task_{i}" for i in range(num_tasks)]

    # ensemble loop (reference run_training.py:208-436)
    best_states = []
    for model_idx in range(cfg.ensemble_size):
        model_dir = os.path.join(save_dir, f"model_{model_idx}") \
            if save_dir else None
        if model_dir and main:
            os.makedirs(model_dir, exist_ok=True)

        # reference-stream init: the reference's own initial weights under
        # torch.manual_seed(pytorch_seed). With dropout > 0 the reference's
        # later members interleave with training-time draws and cannot be
        # replayed; those members get a seeded Xavier init.
        use_ref_init = cfg.reference_init is None or cfg.reference_init
        if use_ref_init and (cfg.dropout == 0 or model_idx == 0):
            model = reference_init_model(model_cfg, cfg.pytorch_seed,
                                         model_idx)
            debug(f"Model {model_idx}: reference-stream torch init "
                  f"(pytorch_seed {cfg.pytorch_seed})")
        else:
            gen = torch.Generator().manual_seed(
                cfg.pytorch_seed * 1000003 + model_idx)
            model = init_model(MoleculeModel(model_cfg), gen)
        # warm start: only matching-shape parameters are taken
        if cfg.checkpoint_paths:
            warm = cfg.checkpoint_paths[model_idx % len(cfg.checkpoint_paths)]
            loaded = _as_shared(load_checkpoint(warm)[0], cfg)
            merged, n_used, n_skipped = _merge_matching(params_to_jax(model),
                                                        loaded)
            load_jax_params(model, merged)
            info(f"Warm-started model {model_idx} from {warm} "
                 f"({n_used} parameters loaded, {n_skipped} kept fresh)")
        info(f"Number of parameters = {param_count(model.parameters()):,}")

        schedule = build_schedule(
            cfg.scheduler, init_lr=cfg.init_lr, max_lr=cfg.max_lr,
            final_lr=cfg.final_lr, warmup_epochs=cfg.warmup_epochs,
            epochs=cfg.epochs, steps_per_epoch=steps_per_epoch)
        if cfg.checkpoint_frzn is not None:
            load_jax_params(model, _load_frzn_into(
                params_to_jax(model), cfg.checkpoint_frzn, cfg))
        model.to(device)
        mask = _trainable_mask(model, cfg)
        optimizer = build_optimizer(
            cfg.optimizer,
            [p for name, p in model.named_parameters() if mask[name]],
            cfg.weight_decay)
        target_weights = (torch.as_tensor(cfg.target_weights,
                                          dtype=torch.float32, device=device)
                          if cfg.target_weights is not None else None)
        dropout_gen = None
        if cfg.dropout > 0:
            # each data-parallel rank draws its own masks
            dropout_gen = torch.Generator(device=device).manual_seed(
                cfg.pytorch_seed * 1000003 + model_idx
                + (104729 * rank if dp_enabled else 0))
        loss_fn = make_loss_fn(model_cfg, target_weights,
                               cfg.alternative_loss_function, None)
        # with several ranks, a step every rank takes alike (the
        # graph-parallel fallback, or no parallel mode) averages its
        # gradients over them, so the ranks keep one set of parameters
        train_step = TrainStep(
            model, optimizer, schedule, loss_fn, grad_clip=cfg.grad_clip,
            generator=dropout_gen,
            reduce=flat_all_reduce(dist.group.WORLD, 1.0 / n_dev)
            if n_dev > 1 else None)
        steps = [train_step]
        if dp_enabled:
            dp_step = make_dp_train_step(
                model, optimizer, schedule, dp_mesh, "dp", target_weights,
                cfg.alternative_loss_function, None, cfg.grad_clip,
                dropout_gen)
            steps.append(dp_step)
        if gp_enabled:
            gp_dropout = cfg.dropout > 0
            gp_step = make_halo_dp_train_step(
                model, optimizer, schedule, gp_mesh,
                target_weights=target_weights,
                overlap=cfg.graph_parallel_overlap,
                dropout_rngs=gp_dropout,
                use_features=bool(train_data.features_size()),
                grad_clip=cfg.grad_clip)
            steps.append(gp_step.train_step)
            # the dropout seeds of every step, alike on every rank
            gp_seeds = np.random.default_rng(
                [cfg.pytorch_seed, model_idx])

        def set_count(count):
            for st in steps:
                st.count = count

        start_epoch = 0
        # full resume (reference run_training.py:241-263)
        resume_path = None
        if cfg.resume_from_checkpoint:
            resume_path = cfg.resume_from_checkpoint
        elif cfg.resume_experiment and model_dir and \
                os.path.exists(os.path.join(model_dir, "model.ckpt")):
            resume_path = os.path.join(model_dir, "model.ckpt")
        if resume_path and os.path.exists(resume_path):
            params, _, _, saved_epoch = load_checkpoint(resume_path)
            load_jax_params(model, params)
            leaves = load_opt_leaves(resume_path)
            if leaves is not None:
                set_count(opt_state_from_leaves(model, optimizer, leaves))
            start_epoch = (saved_epoch or 0) + 1
            info(f"Resumed from {resume_path} at epoch {start_epoch}")

        # per-epoch CSV metric log (reference run_training.py:212-231)
        csv_path = os.path.join(model_dir, "train_val_loss_log.csv") \
            if model_dir and main else None
        if csv_path and start_epoch == 0:
            header = ["epoch", "train_loss"]
            for metric in cfg.metrics:
                header += [f"train_avg_{metric}", f"val_avg_{metric}"]
                header += [f"train_{t}_{metric}" for t in task_names]
                header += [f"val_{t}_{metric}" for t in task_names]
            header += ["param_norm", "gradient_norm"]
            with open(csv_path, "w", newline="") as f:
                csv.writer(f).writerow(header)

        def snapshot():
            return {k: v.detach().clone()
                    for k, v in model.state_dict().items()}

        def save(name, epoch, with_optimizer):
            save_checkpoint(
                os.path.join(model_dir, name), params_to_jax(model),
                cfg.to_dict(), scalers=scalers, epoch=epoch,
                opt_leaves=opt_state_to_leaves(model, optimizer,
                                               train_step.count)
                if with_optimizer else None)

        # TensorBoard scalars (reference run_training.py:233-236, 393-402),
        # imported here: the package is optional, as in the JAX package
        tb_writer = None
        if cfg.tensorboard and model_dir and main:
            try:
                from torch.utils.tensorboard import SummaryWriter
                tb_writer = SummaryWriter(log_dir=model_dir)
            except Exception as exc:
                info(f"TensorBoard unavailable ({exc}); skipping event logs")

        def run_step(step, *args, **kwargs):
            out = step(*args, **kwargs)
            # every step function shares the optimizer's update count
            set_count(step.count if isinstance(step, TrainStep)
                      else step.train_step.count)
            return out

        def gp_flush(group, losses, gnorms):
            """One 2-D halo step over ``group`` (one loader batch a dp
            row), or, for a batch the partitioner refuses, the same
            batches one by one on the single-device step (JAX
            trainer.py:639-691), each in the dst-sorted layout so that
            its sums run in a fixed order."""
            nonlocal gp_fallback_warned
            n_real = len(group)
            gp_batches[0] += n_real
            group = group + [group[-1].masked_out()] * (gp_dp - n_real)
            trees = [batch_pytree(b) for b in group]
            aw = (train_loader.estimated_pad_atoms() + 7) // 8 * 8
            try:
                sharded, replicated = build_edge_shards_halo_dp(
                    [t["graphs"] for t in trees], gp_n_ep, atom_window=aw,
                    atom_descriptors_list=[t.get("atom_descriptors")
                                           for t in trees]
                    if "atom_descriptors" in trees[0] else None)
            except ValueError as exc:
                if not gp_fallback_warned:
                    info(f"graph_parallel: single-device fallback for an "
                         f"unshardable batch ({exc})")
                    gp_fallback_warned = True
                gp_batches[1] += n_real
                for b in group[:n_real]:
                    loss, gnorm = run_step(
                        train_step, batch_tensors(b.sorted_layout(), device))
                    losses.append(loss)
                    gnorms.append(gnorm)
                return
            stack = lambda k: np.stack([t[k] for t in trees])
            seeds = gp_seeds.integers(0, 2 ** 31, size=(gp_dp, gp_n_ep))
            loss, gnorm = run_step(
                gp_step, sharded, replicated, stack("targets"),
                stack("mask"), stack("weights"), seeds=seeds,
                ffn_seed=int(gp_seeds.integers(0, 2 ** 31)),
                features=stack("features") if "features" in trees[0]
                else None)
            losses.append(loss)
            gnorms.append(gnorm)

        eval_args = (num_tasks, cfg.metrics, cfg.dataset_type, device, scaler)
        best_score = float("inf") if cfg.minimize_score else -float("inf")
        best_epoch = 0
        best_state = snapshot()
        for epoch in range(start_epoch, cfg.epochs):
            # a trace of the first epoch (JAX trainer.py:589-593)
            prof = None
            if cfg.profile_dir and epoch == start_epoch and model_idx == 0 \
                    and main:
                prof = _start_profile(device)
            losses, gnorms = [], []
            t_epoch = time.perf_counter()
            if dp_enabled:
                for batch in train_loader.iter_rank(dp_mesh.coord("dp"),
                                                    n_dev):
                    loss, gnorm = run_step(dp_step,
                                           [batch_tensors(batch, device)])
                    losses.append(loss)
                    gnorms.append(gnorm)
            elif gp_enabled:
                group = []
                for batch in train_loader:
                    group.append(batch)
                    if len(group) == gp_dp:
                        gp_flush(group, losses, gnorms)
                        group = []
                if group:
                    gp_flush(group, losses, gnorms)
            else:
                for batch in train_loader:
                    loss, gnorm = run_step(train_step,
                                           batch_tensors(batch, device))
                    # no per-step readback: the epoch's scalars are
                    # fetched in one stacked transfer below
                    losses.append(loss)
                    gnorms.append(gnorm)
            if losses:
                fetched = torch.stack(losses + gnorms).cpu().numpy()
                losses = fetched[:len(losses)].tolist()
                gnorms = fetched[len(losses):].tolist()
            epoch_s = time.perf_counter() - t_epoch
            if prof is not None:
                trace = _stop_profile(prof, device, cfg.profile_dir,
                                      model_dir)
                debug(f"Wrote the profiler trace of epoch {epoch} to "
                      f"{trace}")
            if main:
                score = _end_of_epoch(
                    cfg, epoch, model, losses, gnorms, epoch_s, val_loader,
                    train_eval_loader, eval_args, csv_path, tb_writer, debug)
                # every-epoch resume checkpoint (run_training.py:404-409)
                if model_dir:
                    save("model.ckpt", epoch, with_optimizer=True)
                improved = (score < best_score) if cfg.minimize_score \
                    else (score > best_score)
                if improved or epoch == start_epoch:
                    best_score, best_epoch = score, epoch
                    best_state = snapshot()
                    if model_dir:
                        save("best_model.ckpt", epoch, with_optimizer=False)
            if n_dev > 1:
                dist.barrier()

        if tb_writer is not None:
            tb_writer.close()
        if gp_enabled:
            info(f"graph_parallel: {gp_batches[1]} of {gp_batches[0]} "
                 f"batches fell back to the single-device step")
            gp_batches[:] = [0, 0]
        info(f"Model {model_idx} best validation {cfg.metric} = "
             f"{best_score:.6f} on epoch {best_epoch}")
        best_states.append(best_state)

    ensemble_scores = None
    if main:
        ensemble_scores = _test_scores(cfg, model, best_states, test_loader,
                                       test_data, device, scaler, num_tasks,
                                       info)
    if n_dev > 1:
        box = [ensemble_scores]
        dist.broadcast_object_list(box, src=0)
        ensemble_scores = box[0]
    return ensemble_scores


def _end_of_epoch(cfg, epoch, model, losses, gnorms, epoch_s, val_loader,
                  train_eval_loader, eval_args, csv_path, tb_writer,
                  debug) -> float:
    """Evaluate and log one epoch (reference run_training.py:383-402):
    validation (and, with a CSV log, train-set) scores, the CSV row, the
    TensorBoard scalars; returns the average validation score."""
    val_scores = evaluate(model, val_loader, *eval_args)
    train_scores = evaluate(model, train_eval_loader, *eval_args) \
        if csv_path else None
    avg_val = float(np.nanmean(val_scores[cfg.metric]))
    mean_loss = float(np.mean(losses)) if losses else float("nan")
    pnorm = compute_pnorm(model.parameters())
    mean_gnorm = float(np.mean(gnorms)) if gnorms else float("nan")
    debug(f"Epoch {epoch}: train loss = {mean_loss:.6f}, "
          f"val {cfg.metric} = {avg_val:.6f}, "
          f"PNorm = {pnorm:.4f}, GNorm = {mean_gnorm:.4f}, "
          f"{len(losses) / max(epoch_s, 1e-9):.1f} steps/s")
    if csv_path:
        row = [epoch, mean_loss]
        for metric in cfg.metrics:
            tv, vv = train_scores[metric], val_scores[metric]
            row += [float(np.nanmean(tv)), float(np.nanmean(vv))]
            row += list(tv) + list(vv)
        row += [pnorm, mean_gnorm]
        with open(csv_path, "a", newline="") as f:
            csv.writer(f).writerow(row)
    if tb_writer is not None:
        tb_writer.add_scalar("train_loss", mean_loss, epoch)
        tb_writer.add_scalar(f"validation_{cfg.metric}", avg_val, epoch)
        tb_writer.add_scalar("param_norm", pnorm, epoch)
        tb_writer.add_scalar("gradient_norm", mean_gnorm, epoch)
    return avg_val


def _test_scores(cfg, model, best_states, test_loader, test_data, device,
                 scaler, num_tasks, info) -> Dict[str, List[float]]:
    """Test evaluation with ensemble averaging (run_training.py:440-491)
    and the test files."""
    test_targets = test_loader.targets()
    sum_preds = None
    for state in best_states:
        model.load_state_dict(state)
        preds, _ = predict(model, test_loader, device, scaler=scaler)
        arr = np.array(preds, dtype=float)
        sum_preds = arr if sum_preds is None else sum_preds + arr
        scores = evaluate_predictions(preds, test_targets, num_tasks,
                                      cfg.metrics, cfg.dataset_type)
        for metric, vals in scores.items():
            info(f"Model test {metric} = {np.nanmean(vals):.6f}")
    avg_preds = (sum_preds / len(best_states)).tolist()
    ensemble_scores = evaluate_predictions(avg_preds, test_targets, num_tasks,
                                           cfg.metrics, cfg.dataset_type)
    for metric, vals in ensemble_scores.items():
        info(f"Ensemble test {metric} = {np.nanmean(vals):.6f}")

    if cfg.save_dir and cfg.save_preds and len(test_data) > 0:
        _write_test_preds(cfg.save_dir, test_data, avg_preds)
    if cfg.save_dir:
        with open(os.path.join(cfg.save_dir, "test_scores.json"), "w") as f:
            json.dump(ensemble_scores, f, indent=4, sort_keys=True)
    return ensemble_scores


def _scale_features(cfg: TrainConfig, train_data, val_data,
                    test_data) -> Dict:
    """Fit the feature scalers on the training set and apply them to all
    three sets (reference run_training.py:111-130, JAX trainer.py:276-296):
    molecule features, atom descriptors (or extra atom features) and bond
    features, each unless its ``no_*_scaling`` flag is set. Returns the
    checkpoint's scaler dict, ``data_scaler`` still None."""
    sets = (val_data, test_data)
    features_scaler = ad_scaler = bf_scaler = None
    if train_data.features() is not None and not cfg.no_features_scaling:
        features_scaler = train_data.normalize_features(replace_nan_token=0)
        for ds in sets:
            ds.normalize_features(features_scaler)
    if len(train_data) and (train_data[0].atom_descriptors is not None or
                            train_data[0].atom_features is not None) \
            and not cfg.no_atom_descriptor_scaling:
        ad_scaler = train_data.normalize_features(
            replace_nan_token=0, scale_atom_descriptors=True)
        for ds in sets:
            ds.normalize_features(ad_scaler, scale_atom_descriptors=True)
    if len(train_data) and train_data[0].bond_features is not None \
            and not cfg.no_bond_features_scaling:
        bf_scaler = train_data.normalize_features(
            replace_nan_token=0, scale_bond_features=True)
        for ds in sets:
            ds.normalize_features(bf_scaler, scale_bond_features=True)
    return {"data_scaler": None, "features_scaler": features_scaler,
            "atom_descriptor_scaler": ad_scaler,
            "bond_feature_scaler": bf_scaler}


def _normalize_spectra_targets(train_data, val_data, test_data,
                               cfg: TrainConfig) -> None:
    """Spectra normalization with optional phase masks (reference
    spectra_utils.py:162-208 + run_training.py:147-158, JAX
    trainer.py:833-862): masked-out regions become missing targets, values
    below ``spectra_target_floor`` are raised to it, and each spectrum is
    scaled to sum 1."""
    phase_mask = None
    if cfg.spectra_phase_mask_path:
        phase_mask = _load_phase_mask(cfg.spectra_phase_mask_path)
    for ds in (train_data, val_data, test_data):
        if len(ds) == 0:
            continue
        # dedicated phase features when provided (reference data.py:327-336),
        # else the RAW molecule features as one-hot phases: the phase
        # indicator is never the scaled features
        if phase_mask is not None:
            phase_feats = ds.phase_features() or [d.raw_features for d in ds]
        else:
            phase_feats = None
        new_targets = []
        for i, t in enumerate(ds.targets()):
            arr = np.array([np.nan if x is None else x for x in t],
                           dtype=float)
            if phase_mask is not None and phase_feats is not None \
                    and phase_feats[i] is not None:
                phase = np.asarray(phase_feats[i], dtype=float)
                mask_row = phase @ np.asarray(phase_mask, dtype=float)
                arr = np.where(mask_row > 0, arr, np.nan)
            arr = np.where(arr < cfg.spectra_target_floor,
                           cfg.spectra_target_floor, arr)
            total = np.nansum(arr)
            arr = arr / total if total > 0 else arr
            new_targets.append([None if np.isnan(x) else float(x)
                                for x in arr])
        ds.set_targets(new_targets)


def _load_phase_mask(path: str) -> List[List[float]]:
    """One row of 0/1 per phase, one column per spectrum position after
    the phase name (reference spectra_utils.py:244-264)."""
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        return [[float(v) for v in row[1:]] for row in reader]


def _write_test_preds(save_dir: str, test_data, avg_preds) -> None:
    """(reference run_training.py:493-497)."""
    path = os.path.join(save_dir, "test_preds.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles"] + [f"pred_{i}" for i in
                                 range(len(avg_preds[0]) if avg_preds else 0)])
        for d, p in zip(test_data, avg_preds):
            row_p = p if isinstance(p, list) else [p]
            w.writerow([".".join(d.smiles)] + row_p)
