"""Hyperparameter optimization with a native TPE implementation
(reference hyperparameter_optimization.py:21-164 + hyperopt_utils.py).

The port's copy of polymer_chemprop_tpu hyperparameter_optimization.py on
the port's ``cross_validate``: every trial trains on ``cfg.device`` (CUDA
unless ``--device cpu``). Trials above hidden 1,495 take the encoder's
``plain`` layer form (EncoderConfig.layer_form).

The reference uses the ``hyperopt`` package's Tree-structured Parzen
Estimator over {hidden_size 300-2400/100, depth 2-6, dropout 0-0.4/0.05,
ffn_num_layers 1-3} (hyperparameter_optimization.py:21-27). That package
isn't available here, so the same TPE algorithm is implemented directly:
split observed trials into good/bad by quantile, model each group with a
categorical density over the discrete grid, and pick the candidate
maximizing l(x)/g(x).

Parallel-instance support mirrors the reference's file-based trial
checkpointing (hyperopt_utils.py:42-113): one JSON per trial in a shared
directory plus a seed file; concurrent workers merge trials on load.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from .config import TrainConfig
from .train.cross_validate import cross_validate
from .utils.logging import get_logger, timeit

# Search space (reference hyperparameter_optimization.py:21-27)
SPACE = {
    "hidden_size": list(range(300, 2401, 100)),
    "depth": list(range(2, 7)),
    "dropout": [round(0.05 * i, 2) for i in range(9)],
    "ffn_num_layers": list(range(1, 4)),
}
INT_KEYS = ["hidden_size", "depth", "ffn_num_layers"]


class TPE:
    """Tree-structured Parzen Estimator over a discrete grid."""

    def __init__(self, space: Dict[str, list], gamma: float = 0.25,
                 n_candidates: int = 24, n_startup: int = 10, seed: int = 0):
        self.space = space
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup = n_startup
        self.rng = random.Random(seed)

    def _sample_uniform(self) -> Dict:
        return {k: self.rng.choice(v) for k, v in self.space.items()}

    def _density(self, values: list, grid: list, prior: float = 1.0) -> np.ndarray:
        counts = np.full(len(grid), prior)
        index = {v: i for i, v in enumerate(grid)}
        for v in values:
            if v in index:
                counts[index[v]] += 1
        return counts / counts.sum()

    def suggest(self, history: List[Dict]) -> Dict:
        """history: [{'params': {...}, 'loss': float}] (lower is better)."""
        done = [h for h in history if h.get("loss") is not None
                and not np.isnan(h["loss"])]
        if len(done) < self.n_startup:
            return self._sample_uniform()
        done = sorted(done, key=lambda h: h["loss"])
        n_good = max(1, int(np.ceil(self.gamma * len(done))))
        good, bad = done[:n_good], done[n_good:]
        dens = {}
        for k, grid in self.space.items():
            lg = self._density([h["params"][k] for h in good], grid)
            gg = self._density([h["params"][k] for h in bad], grid)
            dens[k] = (grid, lg, gg)
        best, best_score = None, -np.inf
        for _ in range(self.n_candidates):
            cand, score = {}, 0.0
            for k, (grid, lg, gg) in dens.items():
                i = self.rng.choices(range(len(grid)), weights=lg)[0]
                cand[k] = grid[i]
                score += np.log(lg[i]) - np.log(gg[i])
            if score > best_score:
                best, best_score = cand, score
        return best


# -- file-based trial persistence (reference hyperopt_utils.py:42-113) -------

def load_trials(trials_dir: str) -> List[Dict]:
    trials = []
    if os.path.isdir(trials_dir):
        for fname in sorted(os.listdir(trials_dir)):
            if fname.startswith("trial_") and fname.endswith(".json"):
                with open(os.path.join(trials_dir, fname)) as f:
                    trials.append(json.load(f))
    return trials


def save_trial(trials_dir: str, trial: Dict) -> None:
    os.makedirs(trials_dir, exist_ok=True)
    key = trial["key"]
    with open(os.path.join(trials_dir, f"trial_{key}.json"), "w") as f:
        json.dump(trial, f)


def get_hyperopt_seed(seed: int, trials_dir: str) -> int:
    """Shared monotone seed file so parallel instances draw distinct seeds
    (reference hyperopt_utils.py:83-113). The read-pick-append cycle runs
    under an exclusive ``fcntl`` lock on the seed file itself, so truly
    concurrent workers cannot draw the same seed (the reference's
    unlocked append has that race)."""
    os.makedirs(trials_dir, exist_ok=True)
    path = os.path.join(trials_dir, "hyperopt_seeds.txt")
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        try:
            import fcntl
            fcntl.flock(fd, fcntl.LOCK_EX)
        except ImportError:  # non-POSIX: best effort, like the reference
            pass
        content = os.read(fd, 1 << 20).decode() or ""
        seeds = [int(s) for s in content.split()]
        while seed in seeds:
            seed += 1
        os.lseek(fd, 0, os.SEEK_END)
        os.write(fd, f"{seed} ".encode())
        os.fsync(fd)
    finally:
        os.close(fd)  # releases the flock
    return seed


def hyperopt(cfg: TrainConfig, num_iters: int = 20,
             hyperopt_checkpoint_dir: Optional[str] = None,
             manual_trial_dirs: Optional[List[str]] = None,
             config_save_path: Optional[str] = None,
             startup_random_iters: int = 10,
             log_dir: Optional[str] = None) -> Dict:
    """TPE search; objective = cross_validate mean score
    (reference hyperparameter_optimization.py:31-156)."""
    logger = get_logger("hyperopt", log_dir or cfg.save_dir, cfg.quiet)
    trials_dir = hyperopt_checkpoint_dir or \
        os.path.join(cfg.save_dir or ".", "hyperopt_trials")

    # manual/warm-start trials (reference hyperopt_utils.py:116+): import
    # EVERY trial record from each prior run — the full trial_*.json
    # history (checked both at the dir root and in its hyperopt_trials/
    # subdir, the default layout), falling back to best_hyperparams.json
    # for directories that only kept the summary
    if manual_trial_dirs:
        for d in manual_trial_dirs:
            base = os.path.basename(os.path.normpath(d))
            imported = 0
            for sub in (d, os.path.join(d, "hyperopt_trials")):
                for rec in load_trials(sub):
                    if "params" not in rec:
                        continue
                    save_trial(trials_dir, dict(
                        rec, key=f"manual_{base}_{rec.get('key', imported)}"))
                    imported += 1
            if imported == 0:
                path = os.path.join(d, "best_hyperparams.json")
                if os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    save_trial(trials_dir, {"key": f"manual_{base}",
                                            "params": rec["params"],
                                            "loss": rec.get("loss")})
                    imported = 1
            logger.info(f"Imported {imported} manual trial(s) from {d}")

    for i in range(num_iters):
        trials = load_trials(trials_dir)
        if len(trials) >= num_iters:
            break
        seed = get_hyperopt_seed(cfg.seed + len(trials), trials_dir)
        tpe = TPE(SPACE, n_startup=startup_random_iters, seed=seed)
        params = tpe.suggest(trials)
        trial_cfg = TrainConfig.from_dict(cfg.to_dict())
        for k, v in params.items():
            setattr(trial_cfg, k, int(v) if k in INT_KEYS else float(v))
        trial_cfg.ffn_hidden_size = trial_cfg.hidden_size
        trial_cfg.save_dir = os.path.join(cfg.save_dir or ".",
                                          f"trial_seed_{seed}")
        logger.info(f"Trial {len(trials)}: {params}")
        mean_score, std_score = cross_validate(trial_cfg)
        loss = mean_score if trial_cfg.minimize_score else -mean_score
        if np.isnan(loss):
            loss = None  # failed classification fold etc.
        save_trial(trials_dir, {"key": f"seed_{seed}", "params": params,
                                "loss": loss, "mean_score": mean_score,
                                "std_score": std_score})

    trials = [t for t in load_trials(trials_dir) if t.get("loss") is not None]
    best = min(trials, key=lambda t: t["loss"])
    result = {"params": best["params"], "loss": best["loss"],
              "mean_score": best.get("mean_score")}
    out_path = os.path.join(cfg.save_dir or ".", "best_hyperparams.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    if config_save_path:
        # chemprop-style best-config JSON consumable via --config_path
        # (reference hyperparameter_optimization.py:152-156)
        os.makedirs(os.path.dirname(config_save_path) or ".", exist_ok=True)
        cfg_out = {k: (int(v) if k in INT_KEYS else float(v))
                   for k, v in best["params"].items()}
        cfg_out["ffn_hidden_size"] = cfg_out["hidden_size"]
        with open(config_save_path, "w") as f:
            json.dump(cfg_out, f, indent=4, sort_keys=True)
    logger.info(f"Best hyperparameters: {best['params']} "
                f"(score {best.get('mean_score')})")
    return result


@timeit()
def chemprop_hyperopt(argv: Optional[List[str]] = None) -> None:
    """CLI entry (reference hyperparameter_optimization.py:159-164)."""
    import argparse
    from .config import _add_field_args
    parser = argparse.ArgumentParser(
        prog="polymer_chemprop_tpu_torch hyperopt")
    _add_field_args(parser, TrainConfig)
    parser.add_argument("--num_iters", "--num_iter", dest="num_iters",
                        type=int, default=20)
    parser.add_argument("--hyperopt_checkpoint_dir", type=str, default=None)
    parser.add_argument("--manual_trial_dirs", nargs="*", default=None)
    parser.add_argument("--config_save_path", type=str, default=None)
    parser.add_argument("--startup_random_iters", type=int, default=10)
    parser.add_argument("--log_dir", type=str, default=None)
    ns = parser.parse_args(argv)
    d = vars(ns)
    num_iters = d.pop("num_iters")
    ckpt_dir = d.pop("hyperopt_checkpoint_dir")
    manual = d.pop("manual_trial_dirs")
    config_save_path = d.pop("config_save_path")
    startup_random_iters = d.pop("startup_random_iters")
    log_dir = d.pop("log_dir")
    if d.get("split_sizes") is not None:
        d["split_sizes"] = tuple(d["split_sizes"])
    cfg = TrainConfig.from_dict(d)
    hyperopt(cfg, num_iters=num_iters, hyperopt_checkpoint_dir=ckpt_dir,
             manual_trial_dirs=manual, config_save_path=config_save_path,
             startup_random_iters=startup_random_iters, log_dir=log_dir)
