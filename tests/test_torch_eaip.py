"""The fork's polymer checks through the port
(polymer_chemprop_tpu_torch/eaip.py and polymer_goldens.py).

* the EA/IP generator against the JAX package's
  scripts/make_eaip_benchmark.py: the same 972 rows of each arm (strings
  and labels exactly) and, through the command line, the same bytes;
* featurization of every 97th row of each arm (the rows
  tests/test_eaip_benchmark.py featurizes): the port's ``MolGraph``
  equals the JAX package's exactly, with no warning, and the C++
  featurizer's batch equals the Python path's bit for bit;
* both packages' ``cross_validate`` on 150 rows of each arm (a seeded
  draw), EA and IP, hidden 32, 3 epochs: test RMSE and R² and every
  epoch's log within 1e-4 relative;
* the polymer learning check: the port's dataset is the JAX test's file,
  and the port's run at that test's own size passes on the CPU;
* the runner's command line and its pass rule;
* both checks at full size on the card (marked ``gpu`` and ``golden``;
  skip without a GPU): ``python3 -m pytest tests/test_torch_eaip.py -m gpu
  -q --noconftest`` runs them there.

This file imports the JAX package only inside the tests that compare with
it, so that the card's case runs where there is no JAX.
"""

import csv
import importlib.util
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

from polymer_chemprop_tpu_torch import eaip
from polymer_chemprop_tpu_torch import polymer_goldens as PG
from test_torch_threads import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = {"weighted": False, "blind": True}
GRAPH_FIELDS = ("f_atoms", "f_bonds", "w_atoms", "w_bonds",
                "degree_of_polym")
RTOL = 1e-4
PARITY_ROWS = 150
PARITY = dict(hidden_size=32, epochs=3, num_workers=1, band_precision="highest")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def script():
    """The JAX package's generator script, imported as
    tests/test_eaip_benchmark.py imports it."""
    return _load("make_eaip_benchmark",
                 os.path.join(ROOT, "scripts", "make_eaip_benchmark.py"))


# -- the generator -----------------------------------------------------------

@pytest.mark.parametrize("arm", list(ARMS))
def test_generator_equals_the_jax_script(script, arm):
    got, want = eaip.generate(ARMS[arm]), script.generate(ARMS[arm])
    assert len(got) == len(want) == 972
    assert got == want                  # strings and labels exactly
    assert len({s for s, _, _ in got}) == (972 if arm == "weighted"
                                           else 972 // 3)


@pytest.mark.parametrize("arm", list(ARMS))
def test_command_line_writes_the_script_bytes(script, arm, tmp_path,
                                              monkeypatch, capsys):
    flag = ["--blind-weights"] if ARMS[arm] else []
    port, jax_ = tmp_path / "port.csv", tmp_path / "jax.csv"
    assert eaip.main([str(port), *flag]) == 0
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["make_eaip_benchmark.py", str(jax_),
                                      *flag])
    script.main()
    jax_out = capsys.readouterr().out
    assert port.read_bytes() == jax_.read_bytes()
    assert port_out.replace(str(port), "") == jax_out.replace(str(jax_), "")
    with open(port) as f:
        assert next(csv.reader(f)) == ["smiles", "EA", "IP"]


def test_weights_include_values_that_are_not_bf16_exact():
    """The block chains' 0.075 and 0.85 are no multiples of 1/256: the
    JAX package runs them off its ``unit_bond_weights`` path, and the
    card's kernels are held on them in chip_smoke.py."""
    weights = {w for _, a, b in eaip.bonds_for("block", 0.5, 0.5)
               for w in (a, b)}
    weights |= {w for _, a, b in eaip.bonds_for("random", 0.25, 0.75)
                for w in (a, b)}
    off_grid = {w for w in weights if (w * 256) % 1}
    assert off_grid == {0.075, 0.85}


# -- featurization -----------------------------------------------------------

def _featurized_rows(arm):
    return [s for s, _, _ in eaip.generate(ARMS[arm])[::97]]


@pytest.mark.parametrize("arm", list(ARMS))
def test_mol_graphs_equal_the_jax_package(arm):
    from polymer_chemprop_tpu.features import FeaturizationConfig as JaxFcfg
    from polymer_chemprop_tpu.features import MolGraph as JaxMolGraph
    from polymer_chemprop_tpu_torch.features import (FeaturizationConfig,
                                                      MolGraph)
    rows = _featurized_rows(arm)
    assert len(rows) == 11
    w_bonds = set()
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # weights sum to 1 at every point
        for s in rows:
            got = MolGraph(s, FeaturizationConfig(polymer=True))
            want = JaxMolGraph(s, JaxFcfg(polymer=True))
            for k in GRAPH_FIELDS:
                assert getattr(got, k) == getattr(want, k), (s, k)
            assert got.n_atoms == want.n_atoms and got.n_bonds == want.n_bonds
            w_bonds |= set(got.w_bonds)
    assert (0.075 in w_bonds) == (arm == "weighted")


@pytest.mark.parametrize("arm", list(ARMS))
def test_native_batch_equals_python(arm):
    from polymer_chemprop_tpu_torch import native_ext
    from polymer_chemprop_tpu_torch.features import (FeaturizationConfig,
                                                      mol2graph)
    rows = _featurized_rows(arm)
    want = mol2graph(rows, FeaturizationConfig(polymer=True), align=256)
    got, valid = native_ext.featurize_batch_native(
        rows, pad_atoms=want.f_atoms.shape[0],
        pad_bonds=want.f_bonds.shape[0], n_threads=2, polymer=True)
    assert valid.all()
    for k in ("f_atoms", "f_bonds", "w_atoms", "w_bonds", "b2a", "b2dst",
              "b2revb", "a2mol", "degree_of_polym", "mol_mask"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (got.n_atoms_real, got.n_bonds_real) == (want.n_atoms_real,
                                                    want.n_bonds_real)


# -- training parity ---------------------------------------------------------

def _log(save_dir):
    with open(os.path.join(save_dir, "fold_0", "model_0",
                           "train_val_loss_log.csv")) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module", params=list(ARMS))
def parity_runs(request, tmp_path_factory):
    """Both packages' ``cross_validate`` on the same 150 rows of one arm."""
    from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
    from polymer_chemprop_tpu.train.cross_validate import (
        cross_validate as jax_cross_validate,
    )
    arm = request.param
    root = tmp_path_factory.mktemp(f"eaip_{arm}")
    rows = eaip.generate(ARMS[arm])
    pick = np.random.default_rng(0).permutation(len(rows))[:PARITY_ROWS]
    rows = [rows[i] for i in pick]
    port_dir = str(root / "port")
    PG.run_arm(rows, port_dir, "cpu", **PARITY)
    jax_dir = str(root / "jax")
    os.makedirs(jax_dir)
    path = os.path.join(jax_dir, "data.csv")
    eaip.write_csv(path, rows)
    jax_cross_validate(JaxTrainConfig(data_path=path, save_dir=jax_dir,
                                      **dict(PG.EAIP_TRAIN, **PARITY)))
    return port_dir, jax_dir


def test_cross_validate_matches_jax_package(parity_runs):
    port_dir, jax_dir = parity_runs
    with open(os.path.join(port_dir, "data.csv"), "rb") as f, \
            open(os.path.join(jax_dir, "data.csv"), "rb") as g:
        assert f.read() == g.read()
    got, want = PG.fold_test_scores(port_dir), PG.fold_test_scores(jax_dir)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    with open(os.path.join(port_dir, "fold_0", "test_scores.json")) as f:
        scores = json.load(f)
    assert set(scores) == {"rmse", "r2"} and len(scores["rmse"]) == 2
    got_log, want_log = _log(port_dir), _log(jax_dir)
    assert len(got_log) == len(want_log) == PARITY["epochs"]
    for g, w in zip(got_log, want_log):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=RTOL,
                                       err_msg=k)


# -- polymer learning --------------------------------------------------------

def test_learning_dataset_equals_the_jax_test(tmp_path):
    jax_test = _load("jax_polymer_learning",
                     os.path.join(ROOT, "tests", "test_polymer_learning.py"))
    PG.make_learning_dataset(str(tmp_path / "port.csv"))
    jax_test._make_dataset(str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    assert PG.LEARNING_MONOMERS == jax_test.MONOMERS


def test_polymer_learning_passes_on_the_cpu(tmp_path):
    """The port at tests/test_polymer_learning.py's own size (240 rows,
    hidden 64, 15 epochs) on the CPU."""
    r = PG.run_polymer_learning("cpu", str(tmp_path))
    assert r.ok and r.scores["r2"] > PG.LEARNING_R2_MIN, r.line()
    assert not any(r.launches.values())      # the plain versions


# -- the runner --------------------------------------------------------------

@pytest.mark.parametrize("weighted,blind,ok", [
    ((0.145, 0.935), (0.230, 0.839), True),
    ((0.145, 0.90), (0.230, 0.839), False),      # R² not above 0.90
    ((0.170, 0.95), (0.200, 0.90), False),       # ratio 0.85 is not below
    ((float("nan"), 0.95), (0.230, 0.839), False),
])
def test_eaip_pass_rule(weighted, blind, ok):
    assert PG.eaip_passes(weighted, blind) is ok


def test_command_line_exits_1_on_a_failed_check(tmp_path, capsys):
    rc = PG.main(["eaip", "--device", "cpu", "--epochs", "1",
                  "--max_data_size", "60", "--hidden_size", "16"])
    out = capsys.readouterr().out
    assert rc == 1
    line = next(x for x in out.splitlines() if x.startswith("POLYMER eaip:"))
    assert "FAIL" in line and "weighted rmse=" in line and "row 1 0" in line
    assert "POLYMER 0 of 1 checks passed" in out


def test_command_line_refuses_unknown_checks_and_defaults_to_cuda():
    with pytest.raises(SystemExit):
        PG.main(["eaip_benchmark", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            PG.main(["polymer_learning"])


# -- both checks at full size on the card -----------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the checks run the "
                    "port's CUDA kernels at full width)")


@pytest.mark.gpu
@pytest.mark.golden
@pytest.mark.parametrize("name", PG.CHECKS)
def test_polymer_check_on_the_card(cuda, tmp_path, name):
    r = PG.run_check(name, "cuda", str(tmp_path))
    print(r.line())
    assert r.ok, r.line()
    assert r.launches["band_rev_layer"] == \
        r.tc_launches["band_rev_layer"] > 0
