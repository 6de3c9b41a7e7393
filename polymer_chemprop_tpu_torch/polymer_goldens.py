"""The fork's polymer checks through the port.

Two checks of the wD-MPNN's headline claim, as the JAX package's tests
state them:

* ``eaip`` (``tests/test_eaip_benchmark.py``): the reconstructed EA/IP
  benchmark (``eaip.py``, 972 copolymers) through ``cross_validate`` at
  the default widths (hidden 300, depth 3, FFN 2 x 300, ``band_precision``
  "high"), 60 epochs, 1 fold, seed and pytorch_seed 0, batch 50, metric
  RMSE with R², once on the weighted ensemble strings and once on the
  architecture-blind copy of the same data. It passes if the weighted
  arm's R² (the mean over EA and IP) exceeds 0.90 and its RMSE is below
  0.85 times the blind arm's.
* ``polymer_learning`` (``tests/test_polymer_learning.py``): 240
  synthetic copolymers whose target depends on stoichiometry, the
  monomers and Xn, through ``run_training`` (hidden 64, 15 epochs, batch
  25). It passes if the test R² exceeds 0.8.

Usage:
    python -m polymer_chemprop_tpu_torch.polymer_goldens [eaip]
        [polymer_learning] [--device cuda|cpu] [--epochs N]
        [--max_data_size N] [--hidden_size N]

With no names it runs both. The three options cut the size of a run
(for reduced runs; the checks' thresholds stay). Each check prints one
``POLYMER <name>: ...`` line with its scores, ``pass`` or ``FAIL``, its
seconds and the launches of the rows 1-3 kernels (``band_rev_layer``,
``band_rev_bwd``, ``atom_readout``); the exit code is 1 if a check
fails. The device is CUDA unless ``--device cpu`` is given; without a
GPU the CUDA default raises, as every entry point of the port does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import eaip
from .goldens import _sync, card_line
from .ops import band_mpnn as bm

# tests/test_eaip_benchmark.py:37-41, without data_path and save_dir
EAIP_TRAIN = dict(dataset_type="regression", polymer=True, epochs=60,
                  num_folds=1, seed=0, pytorch_seed=0, batch_size=50,
                  quiet=True, metric="rmse", extra_metrics=["r2"])
EAIP_R2_MIN = 0.90              # tests/test_eaip_benchmark.py:55
EAIP_RMSE_RATIO_MAX = 0.85      # tests/test_eaip_benchmark.py:57
ARMS = ("weighted", "blind")
# the JAX package's CPU path (docs/parity.md:543-552): (RMSE eV, R²)
JAX_CPU = {"weighted": (0.145, 0.935), "blind": (0.230, 0.839)}

# tests/test_polymer_learning.py:56-61, without data_path and save_dir
LEARNING_TRAIN = dict(dataset_type="regression", polymer=True, epochs=15,
                      batch_size=25, seed=0, hidden_size=64,
                      ffn_hidden_size=64, metric="r2",
                      extra_metrics=["rmse"], quiet=True, num_workers=2)
LEARNING_R2_MIN = 0.8           # tests/test_polymer_learning.py:70
# tests/test_polymer_learning.py:23-28: (ensemble SMILES, property value)
LEARNING_MONOMERS = {
    "ethylene": ("[*:1]CC[*:2]", 0.0),
    "styrene": ("[*:1]c1ccc([*:2])cc1", 1.0),
    "peg": ("[*:1]CO[*:2]", -0.5),
    "propylene": ("[*:1]C(C)C[*:2]", 0.3),
}
CHECKS = ("eaip", "polymer_learning")
ROWS = {"row 1": "band_rev_layer", "row 2": "band_rev_bwd",
        "row 3": "atom_readout"}


@dataclasses.dataclass
class Result:
    name: str
    scores: Dict[str, float]
    summary: str
    ok: bool
    seconds: float
    launches: Dict[str, int]
    tc_launches: Dict[str, int]

    def counts(self) -> str:
        rows = ", ".join(f"{row} {self.launches[name]}"
                         for row, name in ROWS.items())
        return (f"launches {rows} (row 1 on the tensor cores "
                f"{self.tc_launches['band_rev_layer']})")

    def line(self) -> str:
        return (f"POLYMER {self.name}: {self.summary} "
                f"{'pass' if self.ok else 'FAIL'} {self.seconds:.1f}s; "
                f"{self.counts()}")


def _measured(name, device, run) -> Result:
    """``run()`` -> (scores, summary, ok) with the launches it made and
    its seconds (host clock, synced)."""
    bm.reset_launch_counts()
    t0 = time.perf_counter()
    scores, summary, ok = run()
    _sync(device)
    return Result(name, scores, summary, ok, time.perf_counter() - t0,
                  bm.launch_counts(), bm.tc_launch_counts())


# -- eaip ---------------------------------------------------------------------

def fold_test_scores(save_dir: str) -> Tuple[float, float]:
    """Fold 0's test (RMSE, R²), each the mean over the tasks."""
    with open(os.path.join(save_dir, "fold_0", "test_scores.json")) as f:
        scores = json.load(f)
    return float(np.mean(scores["rmse"])), float(np.mean(scores["r2"]))


def run_arm(rows: List[eaip.Row], save_dir: str, device: str,
            **overrides) -> Tuple[float, float]:
    """One arm through ``cross_validate`` at the JAX test's fields, then
    ``overrides`` (a precision, a reduced size, files to keep): its rows
    are written to ``save_dir/data.csv`` and trained into ``save_dir``;
    the test (RMSE, R²)."""
    from .config import TrainConfig
    from .train.cross_validate import cross_validate
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "data.csv")
    eaip.write_csv(path, rows)
    cross_validate(TrainConfig(data_path=path, save_dir=save_dir,
                               device=device,
                               **dict(EAIP_TRAIN, **overrides)))
    return fold_test_scores(save_dir)


def eaip_passes(weighted: Tuple[float, float],
                blind: Tuple[float, float]) -> bool:
    """The JAX test's two asserts on (RMSE, R²) of each arm."""
    return bool(np.isfinite(weighted + blind).all()
                and weighted[1] > EAIP_R2_MIN
                and weighted[0] < blind[0] * EAIP_RMSE_RATIO_MAX)


def run_eaip(device: str, root: str, **overrides) -> Result:
    """Both arms into ``root/weighted`` and ``root/blind``."""
    def run():
        arms = {arm: run_arm(eaip.generate(blind_weights=arm == "blind"),
                             os.path.join(root, arm), device, **overrides)
                for arm in ARMS}
        (rmse_w, r2_w), (rmse_b, r2_b) = arms["weighted"], arms["blind"]
        scores = {"weighted_rmse": rmse_w, "weighted_r2": r2_w,
                  "blind_rmse": rmse_b, "blind_r2": r2_b,
                  "ratio": rmse_w / rmse_b}
        summary = (f"weighted rmse={rmse_w:.6g} r2={r2_w:.6g} blind "
                   f"rmse={rmse_b:.6g} r2={r2_b:.6g} "
                   f"ratio={scores['ratio']:.6g}")
        return scores, summary, eaip_passes(arms["weighted"], arms["blind"])
    return _measured("eaip", device, run)


# -- polymer_learning ---------------------------------------------------------

def make_learning_dataset(path: str, n: int = 240, seed: int = 0) -> None:
    """tests/test_polymer_learning.py's ``_make_dataset``: copolymers of two
    monomers whose target is the stoichiometry-weighted monomer value
    times 1 + log10(Xn), plus N(0, 0.02) noise."""
    rng = np.random.default_rng(seed)
    names = list(LEARNING_MONOMERS)
    rows = ["smiles,target"]
    for _ in range(n):
        a, b = rng.choice(names, size=2, replace=False)
        (sa, va), (sb, vb) = LEARNING_MONOMERS[a], LEARNING_MONOMERS[b]
        sb = sb.replace("[*:1]", "[*:3]").replace("[*:2]", "[*:4]")
        w = float(rng.choice([0.1, 0.25, 0.5, 0.75, 0.9]))
        xn = float(rng.choice([1, 5, 20, 100, 400]))
        target = (w * va + (1 - w) * vb) * (1 + math.log10(xn)) \
            + rng.normal(0, 0.02)
        s = (f"{sa}.{sb}|{w}|{1 - w}|"
             f"<1-3:0.5:0.5<2-4:0.5:0.5~{xn}")
        rows.append(f'"{s}",{target:.4f}')
    with open(path, "w") as f:
        f.write("\n".join(rows))


def run_polymer_learning(device: str, root: str, **overrides) -> Result:
    """The dataset into ``root/poly.csv``, one ``run_training`` into
    ``root/run``."""
    from .config import TrainConfig
    from .data import get_data
    from .train.trainer import run_training

    def run():
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, "poly.csv")
        make_learning_dataset(path)
        cfg = TrainConfig(data_path=path, save_dir=os.path.join(root, "run"),
                          device=device, **dict(LEARNING_TRAIN, **overrides))
        data = get_data(path, config=cfg.featurization(),
                        max_data_size=cfg.max_data_size)
        log = logging.getLogger("polymer_learning")
        log.addHandler(logging.NullHandler())
        log.propagate = False
        scores = run_training(cfg, data, logger=log)
        r2 = float(np.nanmean(scores["r2"]))
        rmse = float(np.nanmean(scores["rmse"]))
        return ({"r2": r2, "rmse": rmse}, f"r2={r2:.6g} rmse={rmse:.6g}",
                bool(np.isfinite(r2)) and r2 > LEARNING_R2_MIN)
    return _measured("polymer_learning", device, run)


RUNNERS = {"eaip": run_eaip, "polymer_learning": run_polymer_learning}


def run_check(name: str, device: str, root: str, **overrides) -> Result:
    if name not in RUNNERS:
        raise ValueError(f"unknown check {name!r}; known: {', '.join(CHECKS)}")
    return RUNNERS[name](device, root, **overrides)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m polymer_chemprop_tpu_torch.polymer_goldens",
        description="Run the fork's polymer checks through the port.")
    parser.add_argument("names", nargs="*",
                        help=f"checks to run, of {', '.join(CHECKS)} (both "
                             "when none is named)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    for size in ("epochs", "max_data_size", "hidden_size"):
        parser.add_argument(f"--{size}", type=int,
                            help="a reduced size (the thresholds stay)")
    args = parser.parse_args(argv)
    unknown = sorted(set(args.names) - set(CHECKS))
    if unknown:
        parser.error(f"unknown checks {unknown}; known: {', '.join(CHECKS)}")
    overrides = {k: getattr(args, k)
                 for k in ("epochs", "max_data_size", "hidden_size")
                 if getattr(args, k) is not None}
    from .train.predict import resolve_device
    resolve_device(args.device)
    print(card_line(args.device), flush=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.names or CHECKS:
            r = run_check(name, args.device, os.path.join(tmp, name),
                          **overrides)
            print(r.line(), flush=True)
            results.append(r)
    failed = [r.name for r in results if not r.ok]
    print(f"POLYMER {len(results) - len(failed)} of {len(results)} checks "
          f"passed in {sum(r.seconds for r in results):.1f}s"
          + (f"; failed: {', '.join(failed)}" if failed else ""), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
