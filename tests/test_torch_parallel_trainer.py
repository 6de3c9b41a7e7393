"""``cli train`` under 2-rank ``torchrun`` on the CPU (gloo): data-parallel
and graph-parallel training end to end, each test score within 1e-3
relative of the port's single-device run on the same data and split.

A data-parallel step takes one micro-batch of ``batch_size / 2`` a rank,
so together the two ranks take the single-device batch, with the exact
global masked loss; a graph-parallel step takes the single-device batch
edge-partitioned over the two ranks. The three launches (regression with
``--data_parallel`` and with ``--graph_parallel``, 100 molecules, 2
epochs; weighted copolymers with ``--graph_parallel``, as the JAX
package's ``test_trainer_gp_polymer``) start together in the background;
the single-device runs go in this process meanwhile. Hidden 32, the
Python featurizer (nothing to build).
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
from test_torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGRESSION = os.path.join(REPO, "tests", "data", "regression.csv")
SMALL = ["--dataset_type", "regression", "--epochs", "2", "--seed", "0",
         "--pytorch_seed", "0", "--hidden_size", "32",
         "--ffn_hidden_size", "32", "--device", "cpu", "--num_workers", "1",
         "--quiet", "--no_use_native_featurizer"]


def _polymer_csv(path):
    """48 weighted copolymers (the JAX package's test_trainer_gp_polymer)."""
    rng = np.random.default_rng(3)
    rows = ["smiles,target"]
    mons = ["[*:1]CC[*:2]", "[*:1]c1ccc([*:2])cc1", "[*:1]CO[*:2]",
            "[*:1]C(C)C[*:2]"]
    for _ in range(48):
        m1, m2 = rng.choice(mons, 2, replace=False)
        m2 = m2.replace("[*:1]", "[*:3]").replace("[*:2]", "[*:4]")
        w = rng.choice([0.25, 0.5, 0.75])
        st = (f"{m1}.{m2}|{w}|{1 - w}|"
              f"<1-3:0.5:0.5<2-4:0.5:0.5~{rng.integers(2, 100)}")
        rows.append(f'"{st}",{rng.normal():.4f}')
    path.write_text("\n".join(rows))


def _args(kind, tmp):
    if kind == "regression":
        return ["--data_path", REGRESSION, "--batch_size", "20",
                "--max_data_size", "100"] + SMALL
    return ["--data_path", str(tmp / "poly.csv"), "--polymer",
            "--batch_size", "12"] + SMALL


MODES = {"dp": ("regression", "--data_parallel", "Data-parallel"),
         "gp": ("regression", "--graph_parallel", "Graph-parallel"),
         "gp_polymer": ("polymer", "--graph_parallel", "Graph-parallel")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_trainer")
    _polymer_csv(tmp / "poly.csv")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = {}
    for mode, (kind, flag, _) in MODES.items():
        log = open(tmp / f"{mode}.log", "w")
        procs[mode] = (subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", "polymer_chemprop_tpu_torch.cli",
             "train", *_args(kind, tmp), flag, "--save_dir",
             str(tmp / mode)], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), log)
    yield tmp, procs, {}
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def _score(save_dir):
    with open(os.path.join(save_dir, "test_scores.csv")) as f:
        return float(next(csv.DictReader(f))["Mean rmse"])


@pytest.mark.parametrize("mode", list(MODES))
def test_torchrun_train_matches_single_device(runs, mode):
    from polymer_chemprop_tpu_torch.train.cross_validate import chemprop_train
    tmp, procs, single = runs
    kind, _, banner = MODES[mode]
    if kind not in single:
        save_dir = tmp / f"single_{kind}"
        chemprop_train(_args(kind, tmp) + ["--save_dir", str(save_dir)])
        single[kind] = _score(save_dir)
    proc, log = procs[mode]
    rc = proc.wait(timeout=240)
    log.flush()
    out = open(tmp / f"{mode}.log").read()
    assert rc == 0, out[-4000:]
    assert out.count("backend gloo (by rule), device cpu") == 2, out[-2000:]
    # rank 0 alone writes the logs and the files
    verbose = open(tmp / mode / "verbose.log").read()
    assert f"{banner} training" in verbose and "over 2 devices" in verbose
    assert "fallback" not in verbose
    if banner == "Graph-parallel":
        assert "graph_parallel: 0 of " in verbose
    got = _score(tmp / mode)
    assert np.isfinite(got)
    assert abs(got - single[kind]) / abs(single[kind]) < 1e-3, \
        (got, single[kind])


def test_unsupported_config_raises(tmp_path):
    """``graph_parallel`` refuses what the JAX trainer refuses
    (trainer.py:327-343): here one device and ``features_only``."""
    from polymer_chemprop_tpu_torch.config import TrainConfig
    from polymer_chemprop_tpu_torch.data import get_data
    from polymer_chemprop_tpu_torch.train.trainer import run_training
    cfg = TrainConfig(data_path=REGRESSION, dataset_type="regression",
                      epochs=1, batch_size=20, max_data_size=40,
                      save_dir=str(tmp_path), quiet=True, device="cpu",
                      graph_parallel=True, features_only=True,
                      features_generator=["morgan"], num_workers=1)
    data = get_data(cfg.data_path, config=cfg.featurization(),
                    max_data_size=cfg.max_data_size,
                    features_generators=cfg.features_generator)
    with pytest.raises(ValueError, match="graph_parallel is unsupported "
                                         "for this run: single device, "
                                         "features_only"):
        run_training(cfg, data)
