"""The reference's golden-score configurations through the port.

Chemprop v1.4's CI goldens, as the JAX package's
``tests/test_integration.py`` ``TestGoldenScores`` states them: 10 epochs,
3 folds, seed 0 at the default widths (hidden 300, depth 3, batch 50),
each score held to the reference's value within 5% (``DELTA``) or, for
three round trips, within the two-sided bands and upper limits the tests
give. ``GOLDENS`` holds all 25, each with the test's own configuration,
its reference value and band and the test's line; the four short names
of the JAX package's ``scripts/tpu_goldens.py`` are aliases.

Usage:
    python -m polymer_chemprop_tpu_torch.goldens [names...] [--device cuda|cpu]

With no names it runs all of them: MPNN configurations through the port's
``cross_validate`` (and ``make_predictions`` for the round trips), the
baselines through ``cross_validate`` with ``sklearn_train.run_sklearn``
(and ``sklearn_predict.predict_sklearn``), and the graph-parallel golden
through ``cli train --graph_parallel`` under ``torchrun`` at 2 ranks
(ranks that share one card take gloo). Each prints

    GOLDEN <name>: <score> ref=<ref> dev=<+x.x%> <pass|FAIL> <seconds>s

and the exit code is 1 if any score is outside its band. The device is
CUDA unless ``--device cpu`` is given; without a GPU the CUDA default
raises, as every entry point of the port does.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .ops import band_mpnn as bm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
DELTA = 0.05            # the reference's tolerance (its test_integration.py:32)
GP_RANKS = 2
GP_TIMEOUT = 3600       # seconds for the whole torchrun launch

# ``train_cfg``'s base (tests/test_integration.py:28-34); the MPNN goldens
# add their own fields to it
TRAIN_BASE = dict(data_path="regression.csv", dataset_type="regression",
                  epochs=2, num_folds=1, seed=0, quiet=True, num_workers=2)
# the fields that name a file in the data directory
PATH_FIELDS = ("data_path", "features_path", "phase_features_path",
               "spectra_phase_mask_path")

Condition = Tuple  # ("rel", a, tol) | ("between", lo, lo_tol, hi, hi_tol)
#                    | ("below", a, tol)


def rel(anchor: float, tol: float = DELTA) -> Condition:
    """``abs(x - anchor) / anchor < tol``."""
    return ("rel", anchor, tol)


def between(lo: float, lo_tol: float, hi: float, hi_tol: float) -> Condition:
    """``lo * (1 - lo_tol) < x < hi * (1 + hi_tol)``."""
    return ("between", lo, lo_tol, hi, hi_tol)


def below(anchor: float, tol: float = DELTA) -> Condition:
    """``x < anchor * (1 + tol)``."""
    return ("below", anchor, tol)


def holds(cond: Condition, x: float) -> bool:
    kind = cond[0]
    if kind == "rel":
        return abs(x - cond[1]) / cond[1] < cond[2]
    if kind == "between":
        return cond[1] * (1 - cond[2]) < x < cond[3] * (1 + cond[4])
    if kind == "below":
        return x < cond[1] * (1 + cond[2])
    raise ValueError(f"unknown condition {cond!r}")


@dataclasses.dataclass(frozen=True)
class Golden:
    """One configuration of ``TestGoldenScores``.

    ``train`` holds the keyword arguments the test passes to its config
    (``train_cfg``, which adds ``TRAIN_BASE``, or ``SklearnTrainConfig``),
    without ``save_dir``; file names are relative to the data directory.
    Round trips name the predict arguments and the test and truth CSVs.
    ``ref`` is the reference's own value: the upper limit where a band has
    one, else the anchor of its 5%."""

    name: str
    line: int
    train: dict
    band: Tuple[Condition, ...]
    sklearn: bool = False
    predict: Optional[dict] = None
    test_csv: Optional[str] = None
    truth_csv: Optional[str] = None

    @property
    def ref(self) -> float:
        for kind in ("below", "rel"):
            for cond in self.band:
                if cond[0] == kind:
                    return cond[1]
        raise ValueError(f"{self.name}: no reference value in its band")

    @property
    def roundtrip(self) -> bool:
        return self.test_csv is not None

    @property
    def graph_parallel(self) -> bool:
        return bool(self.train.get("graph_parallel"))

    def passes(self, score: float) -> bool:
        return bool(np.isfinite(score)) and all(holds(c, score)
                                                for c in self.band)


FULL = dict(epochs=10, num_folds=3)
CLS = dict(data_path="classification.csv", dataset_type="classification")
REACTION = dict(data_path="reaction_regression.csv", reaction=True,
                reaction_mode="reac_diff")
SPECTRA = dict(data_path="spectra.csv", dataset_type="spectra")
SPECTRA_EXCL = dict(data_path="spectra_exclusions.csv",
                    dataset_type="spectra")
SPECTRA_FEATURES = dict(features_path=["spectra_features.csv"])
SKLEARN = dict(data_path="regression.csv", dataset_type="regression",
               num_folds=3, seed=0, quiet=True)
REG_ROUNDTRIP = dict(test_csv="regression_test_smiles.csv",
                     truth_csv="regression_test_true.csv")
RDKIT_NPZ = dict(features_path=["regression.npz"], no_features_scaling=True)

_TABLE = (
    Golden("regression", 612, dict(FULL), (rel(1.237620),)),
    Golden("classification", 617, dict(CLS, **FULL), (rel(0.691205),)),
    Golden("classification_roundtrip", 632, dict(CLS, **FULL),
           (rel(0.064605),), predict={},
           test_csv="classification_test_smiles.csv",
           truth_csv="classification_test_true.csv"),
    Golden("rf", 653, dict(SKLEARN), (rel(1.582733),), sklearn=True),
    Golden("regression_morgan", 662, dict(FULL, features_generator=["morgan"]),
           (rel(1.834947),)),
    Golden("regression_rdkit", 671, dict(FULL, **RDKIT_NPZ),
           (rel(0.807828),)),
    Golden("regression_rdkit_live_generator", 680,
           dict(FULL, features_generator=["rdkit_2d_normalized"],
                no_features_scaling=True), (rel(0.807828),)),
    Golden("svm", 692, dict(SKLEARN, model_type="svm"), (rel(1.698927),),
           sklearn=True),
    Golden("regression_roundtrip", 734, dict(FULL),
           (between(0.4806, 0.12, 0.5302, 0.12), below(0.561477)),
           predict={}, **REG_ROUNDTRIP),
    Golden("rf_roundtrip", 750, dict(SKLEARN, model_type="random_forest"),
           (rel(0.6878), below(0.945589)), sklearn=True, predict={},
           **REG_ROUNDTRIP),
    Golden("svm_roundtrip", 767, dict(SKLEARN, model_type="svm"),
           (rel(1.015136),), sklearn=True, predict={}, **REG_ROUNDTRIP),
    Golden("morgan_roundtrip", 777, dict(FULL, features_generator=["morgan"]),
           (between(2.9218, 0.12, 2.9977, 0.12), below(3.825271)),
           predict=dict(features_generator=["morgan"]), **REG_ROUNDTRIP),
    Golden("rdkit_roundtrip", 792, dict(FULL, **RDKIT_NPZ), (rel(0.693359),),
           predict=dict(features_path=["regression_test.npz"]),
           **REG_ROUNDTRIP),
    Golden("reaction", 801, dict(REACTION, **FULL), (rel(2.019870),)),
    Golden("regression_graph_parallel", 809,
           dict(FULL, graph_parallel=True), (rel(1.237620),)),
    Golden("regression_scaffold", 818,
           dict(FULL, split_type="scaffold_balanced"), (rel(1.433300),)),
    Golden("classification_rdkit", 825,
           dict(CLS, **FULL, features_path=["classification.npz"],
                no_features_scaling=True), (rel(0.659145),)),
    Golden("classification_rdkit_live_generator", 836,
           dict(CLS, **FULL, features_generator=["rdkit_2d_normalized"],
                no_features_scaling=True), (rel(0.659145),)),
    Golden("classification_morgan", 849,
           dict(CLS, **FULL, features_generator=["morgan"]),
           (rel(0.619021),)),
    Golden("reaction_scaffold", 859,
           dict(REACTION, split_type="scaffold_balanced", **FULL),
           (rel(1.907502),)),
    Golden("reaction_morgan", 869,
           dict(REACTION, features_generator=["morgan"], **FULL),
           (rel(2.846405),)),
    Golden("spectra", 881,
           dict(SPECTRA, split_type="random_with_repeated_smiles",
                **SPECTRA_FEATURES, **FULL), (rel(0.001737553),)),
    Golden("spectra_scaffold", 895,
           dict(SPECTRA, split_type="scaffold_balanced", **SPECTRA_FEATURES,
                **FULL), (rel(0.001323930),)),
    Golden("spectra_exclusions", 908,
           dict(SPECTRA_EXCL, split_type="random_with_repeated_smiles",
                **SPECTRA_FEATURES, **FULL), (rel(0.001617717),)),
    Golden("spectra_phase", 922,
           dict(SPECTRA_EXCL, split_type="random_with_repeated_smiles",
                phase_features_path="spectra_features.csv",
                spectra_phase_mask_path="spectra_mask.csv", **FULL),
           (rel(0.001421315),)),
)
GOLDENS: Dict[str, Golden] = {g.name: g for g in _TABLE}
# scripts/tpu_goldens.py's names
ALIASES = {"reg_rdkit": "regression_rdkit",
           "cls_morgan": "classification_morgan",
           "reaction_morgan": "reaction_morgan",
           "spectra_exclusions": "spectra_exclusions"}


def resolve(name: str) -> Golden:
    try:
        return GOLDENS[ALIASES.get(name, name)]
    except KeyError:
        raise ValueError(f"unknown golden {name!r}; known: "
                         f"{', '.join(GOLDENS)} and the aliases "
                         f"{', '.join(ALIASES)}") from None


def _in_dir(value):
    if isinstance(value, list):
        return [os.path.join(DATA, v) for v in value]
    return os.path.join(DATA, value)


def config_fields(g: Golden, **overrides) -> dict:
    """The configuration's fields with the data directory's paths, then
    ``overrides`` (e.g. ``band_precision``, or a reduced size)."""
    fields = dict(g.train) if g.sklearn else dict(TRAIN_BASE, **g.train)
    for k in PATH_FIELDS:
        if k in fields:
            fields[k] = _in_dir(fields[k])
    fields.update(overrides)
    return fields


def train_config(g: Golden, save_dir: str, device: str, **overrides):
    """The port's ``TrainConfig`` (``SklearnTrainConfig`` for a baseline)."""
    if g.sklearn:
        from .sklearn_train import SklearnTrainConfig as cls
    else:
        from .config import TrainConfig as cls
    return cls(save_dir=save_dir, device=device,
               **config_fields(g, **overrides))


def predict_config(g: Golden, save_dir: str, device: str):
    from .config import PredictConfig
    fields = {k: _in_dir(v) if k in PATH_FIELDS else v
              for k, v in g.predict.items()}
    return PredictConfig(test_path=os.path.join(DATA, g.test_csv),
                         preds_path=os.path.join(save_dir, "preds.csv"),
                         checkpoint_dir=save_dir, device=device, **fields)


def train_argv(fields: dict) -> List[str]:
    """``cli train`` arguments for a configuration's fields."""
    argv = []
    for k, v in fields.items():
        if v is True:
            argv.append(f"--{k}")
        elif v is False:
            argv.append(f"--no_{k}")
        elif isinstance(v, (list, tuple)):
            argv += [f"--{k}", *map(str, v)]
        elif v is not None:
            argv += [f"--{k}", str(v)]
    return argv


def read_truth(path: str) -> np.ndarray:
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    return np.array([[np.nan if v in ("", "nan") else float(v)
                      for v in row[1:]] for row in rows])


def roundtrip_mse(preds, truth_path: str) -> float:
    """The round trips' score: MSE over the truth file's present values."""
    preds = np.asarray(preds, float)
    true = read_truth(truth_path)
    mask = ~np.isnan(true)
    return float(np.mean((preds[mask] - true[mask]) ** 2))


@dataclasses.dataclass
class Result:
    name: str
    score: float
    ref: float
    ok: bool
    seconds: float
    launches: Dict[str, int]
    tc_launches: Dict[str, int]

    @property
    def dev(self) -> float:
        return (self.score - self.ref) / self.ref

    def line(self) -> str:
        return (f"GOLDEN {self.name}: {self.score:.6g} ref={self.ref:.6g} "
                f"dev={100 * self.dev:+.1f}% "
                f"{'pass' if self.ok else 'FAIL'} {self.seconds:.1f}s")


def _sync(device: str) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _graph_parallel(g: Golden, save_dir: str, device: str,
                    overrides: dict) -> Tuple[float, dict, dict]:
    """``cli train`` under ``torchrun --standalone`` at ``GP_RANKS`` ranks;
    the test score (rank 0's ``test_scores.csv``) and the kernel launches
    of all ranks."""
    fields = config_fields(g, save_dir=save_dir, device=device, **overrides)
    os.makedirs(save_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    log_path = os.path.join(save_dir, "ranks.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(GP_RANKS), "-m",
             "polymer_chemprop_tpu_torch.goldens", "--rank_of", save_dir,
             "--", *train_argv(fields)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=GP_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
    if rc != 0:
        with open(log_path) as f:
            print(f.read()[-6000:], file=sys.stderr)
        raise RuntimeError(f"goldens: the torchrun launch of {g.name} "
                           f"failed ({rc}); log in {log_path}")
    launches, tc = dict.fromkeys(bm.launch_counts(), 0), dict.fromkeys(
        bm.tc_launch_counts(), 0)
    for r in range(GP_RANKS):
        with open(os.path.join(save_dir, f"rank{r}.json")) as f:
            counts = json.load(f)
        for k, v in counts["launches"].items():
            launches[k] += v
        for k, v in counts["tc_launches"].items():
            tc[k] += v
    with open(os.path.join(save_dir, "verbose.log")) as f:
        if "Graph-parallel training" not in f.read():
            raise RuntimeError(f"goldens: {g.name} did not train "
                               "graph-parallel")
    with open(os.path.join(save_dir, "test_scores.csv")) as f:
        row = next(csv.DictReader(f))
    metric = next(k for k in row if k.startswith("Mean "))
    return float(row[metric]), launches, tc


def run_golden(g: Golden, device: str, save_dir: str, **overrides) -> Result:
    """Train (and for a round trip, predict) one configuration on
    ``device`` into ``save_dir``; its score against its band, its seconds
    (host clock, synced) and the kernels' launches in it. ``overrides``
    replace configuration fields (a precision, or a reduced size in the
    tests)."""
    from .train.cross_validate import cross_validate
    t0 = time.perf_counter()
    if g.graph_parallel:
        score, launches, tc = _graph_parallel(g, save_dir, device, overrides)
    else:
        bm.reset_launch_counts()
        cfg = train_config(g, save_dir, device, **overrides)
        if g.sklearn:
            from .sklearn_predict import predict_sklearn
            from .sklearn_train import run_sklearn
            score, _ = cross_validate(cfg, train_func=run_sklearn)
            predict = predict_sklearn
        else:
            from .train.make_predictions import make_predictions
            score, _ = cross_validate(cfg)
            predict = make_predictions
        if g.roundtrip:
            preds = predict(predict_config(g, save_dir, device))
            score = roundtrip_mse(preds, os.path.join(DATA, g.truth_csv))
        _sync(device)
        launches, tc = bm.launch_counts(), bm.tc_launch_counts()
    seconds = time.perf_counter() - t0
    return Result(g.name, float(score), g.ref, g.passes(float(score)),
                  seconds, launches, tc)


def _rank_main(out_dir: str, argv: List[str]) -> int:
    """One rank of the graph-parallel golden under torchrun: ``cli train``,
    then its kernel launches into ``out_dir/rank<r>.json``."""
    from . import cli
    bm.reset_launch_counts()
    cli.main(["train", *argv])
    with open(os.path.join(out_dir, f"rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump({"launches": bm.launch_counts(),
                   "tc_launches": bm.tc_launch_counts()}, f)
    return 0


def card_line(device: str) -> str:
    """The device: for CUDA ``nvidia-smi``'s name and power limit."""
    import torch
    if torch.device(device).type != "cuda":
        return "device: cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return f"device: {torch.cuda.get_device_name(0)} ({smi})"


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--rank_of"]:
        return _rank_main(argv[1], argv[3:])
    parser = argparse.ArgumentParser(
        prog="python -m polymer_chemprop_tpu_torch.goldens",
        description="Run the reference's golden-score configurations "
                    "through the port.")
    parser.add_argument("names", nargs="*",
                        help="goldens to run (all when none is named)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    goldens = [resolve(n) for n in args.names] or list(_TABLE)
    from .train.predict import resolve_device
    resolve_device(args.device)
    print(card_line(args.device), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        results = []
        for g in goldens:
            r = run_golden(g, args.device, os.path.join(tmp, g.name))
            print(r.line(), flush=True)
            results.append(r)
    failed = [r.name for r in results if not r.ok]
    print(f"GOLDENS {len(results) - len(failed)} of {len(results)} inside "
          f"their bands in {sum(r.seconds for r in results):.1f}s"
          + (f"; outside: {', '.join(failed)}" if failed else ""),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
