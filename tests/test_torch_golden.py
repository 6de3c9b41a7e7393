"""The port's golden-score table (polymer_chemprop_tpu_torch/goldens.py).

* (a) the table against ``TestGoldenScores`` in tests/test_integration.py,
  read with ``ast``: the same 25 configurations, the same fields, the
  same reference values and the same bands;
* (b) the four short names of scripts/tpu_goldens.py: ``cfg_for(name)``
  field by field against the port's configuration, ``REFS`` against the
  port's values;
* (c) the golden configurations whose combination of options no other
  port test holds, at a reduced size (hidden 32, 60 rows, 2 epochs, 1
  fold), through both packages' ``cross_validate`` and, for the round
  trips, both ``make_predictions``: scores and predictions within the
  trainer tests' ``RTOL`` 1e-3. The configurations left out, and the
  tests that hold them:

  - ``regression``: tests/test_torch_trainer.py
    ``test_cross_validate_matches_jax_package``;
  - ``classification``: tests/test_torch_trainer.py
    ``test_classification_and_multiclass_training_match_jax_package``;
  - ``regression_roundtrip``: tests/test_torch_trainer.py
    ``test_port_checkpoint_predicts_the_same_through_both_packages``;
  - ``regression_rdkit_live_generator``: tests/test_torch_extra_features.py
    ``test_cross_validate_matches_jax_package[rdkit_2d_normalized]``;
  - ``regression_graph_parallel``: tests/test_torch_parallel_trainer.py
    ``test_torchrun_train_matches_single_device[gp]`` (2 ranks against one)
    and the port's own CPU run in ``test_graph_parallel_cli_arguments``
    below;
  - ``rf``, ``rf_roundtrip``: tests/test_torch_sklearn.py
    ``test_forest_regression_score_near_jax`` and
    ``test_cross_validate_writes_a_model_that_reads_back[rf_regression]``
    (the port's forest draws its own trees, so it is held to the JAX
    package's score within 5%, not to its predictions);
  - ``svm``, ``svm_roundtrip``: tests/test_torch_sklearn.py
    ``test_svr_matches_sklearn`` and
    ``test_cross_validate_writes_a_model_that_reads_back[svr]``;

* (d) every configuration at full size on the card, through the module's
  own ``run_golden`` (marked ``gpu`` and ``golden``; skips without a
  GPU): ``python3 -m pytest tests/test_torch_golden.py -m gpu -q
  --noconftest`` reruns the whole set there.

This file imports the JAX package only inside the tests that compare
with it, so that the card's cases run where there is no JAX.
"""

import ast
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from polymer_chemprop_tpu_torch import goldens as G
from test_torch_threads import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTEGRATION = os.path.join(ROOT, "tests", "test_integration.py")
TPU_GOLDENS = os.path.join(ROOT, "scripts", "tpu_goldens.py")
RTOL = 1e-3
SMALL = dict(hidden_size=32, epochs=2, num_folds=1, batch_size=10,
             max_data_size=60, num_workers=1)


# -- (a) the table against TestGoldenScores ---------------------------------

class _Reader:
    """Values of the few expression shapes TestGoldenScores uses."""

    def __init__(self, module: ast.Module):
        self.consts = {}
        for node in module.body:
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Constant):
                for t in node.targets:
                    self.consts[t.id] = node.value.value

    def value(self, node, env=None):
        env = env or {}
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.List):
            return [self.value(e, env) for e in node.elts]
        if isinstance(node, ast.Dict):
            return {self.value(k, env): self.value(v, env)
                    for k, v in zip(node.keys, node.values)}
        if isinstance(node, ast.Name):
            return env[node.id] if node.id in env else self.consts[node.id]
        if isinstance(node, ast.Call) and ast.unparse(node.func) == \
                "os.path.join" and ast.unparse(node.args[0]) == "DATA":
            return self.value(node.args[1], env)
        raise ValueError(f"unread expression {ast.unparse(node)}")

    def kwargs(self, call: ast.Call, env=None, skip=("save_dir",)) -> dict:
        out = {}
        for kw in call.keywords:
            if kw.arg is None:              # **train_kw
                out.update(self.value(kw.value, env))
            elif kw.arg not in skip:
                out[kw.arg] = self.value(kw.value, env)
        return out

    def condition(self, test: ast.Compare):
        """The three band shapes of the asserts, as goldens' conditions."""
        left, ops, right = test.left, test.ops, test.comparators
        if len(ops) == 2:               # A * (1 - t) < x < B * (1 + t)
            lo, hi = left, right[1]
            return G.between(self.value(lo.left), self.value(lo.right.right),
                             self.value(hi.left), self.value(hi.right.right))
        if isinstance(left, ast.BinOp):  # abs(x - A) / A < tol
            return G.rel(self.value(left.right), self.value(right[0]))
        # x < A * (1 + tol)
        return G.below(self.value(right[0].left),
                       self.value(right[0].right.right))


def _call(fn: ast.FunctionDef, name: str):
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and ast.unparse(n.func) == name]
    return calls[0] if calls else None


def _data_file(fn: ast.FunctionDef, reader: _Reader, suffix: str) -> str:
    """The one file of the data directory that the function names with
    this suffix (``os.path.join(DATA, ...)``)."""
    names = {reader.value(n) for n in ast.walk(fn) if isinstance(n, ast.Call)
             and ast.unparse(n.func) == "os.path.join"
             and ast.unparse(n.args[0]) == "DATA"}
    (name,) = [n for n in names if n.endswith(suffix)]
    return name


def integration_goldens():
    """{name: Golden} as tests/test_integration.py states each test."""
    module = ast.parse(open(INTEGRATION).read())
    reader = _Reader(module)
    cls = next(n for n in module.body if isinstance(n, ast.ClassDef)
               and n.name == "TestGoldenScores")
    methods = {n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)}
    helper = methods.pop("_roundtrip_mse")
    base_fn = next(n for n in module.body if isinstance(n, ast.FunctionDef)
                   and n.name == "train_cfg")
    base = reader.kwargs(next(n for n in ast.walk(base_fn)
                              if isinstance(n, ast.Call)
                              and ast.unparse(n.func) == "dict"))
    out = {}
    for name, fn in methods.items():
        band = tuple(reader.condition(n.test) for n in ast.walk(fn)
                     if isinstance(n, ast.Assert))
        kw = dict(sklearn=False, predict=None, test_csv=None, truth_csv=None)
        trip = _call(fn, "self._roundtrip_mse")
        if trip is not None:
            train_kw, predict_kw = (reader.value(a) for a in trip.args[1:3])
            model = reader.kwargs(trip).get("sklearn_model")
            if model:
                train = reader.kwargs(_call(helper, "SklearnTrainConfig"),
                                      {"sklearn_model": model})
            else:
                train = reader.kwargs(_call(helper, "train_cfg"),
                                      {"train_kw": train_kw})
            kw.update(sklearn=bool(model), predict=predict_kw,
                      test_csv=_data_file(helper, reader, "_smiles.csv"),
                      truth_csv=_data_file(helper, reader, "_true.csv"))
        elif _call(fn, "SklearnTrainConfig") is not None:
            train = reader.kwargs(_call(fn, "SklearnTrainConfig"))
            kw["sklearn"] = True
        else:
            train = reader.kwargs(_call(fn, "train_cfg"))
            predict = _call(fn, "PredictConfig")
            if predict is not None:
                kw.update(predict=reader.kwargs(predict, skip=(
                    "test_path", "preds_path", "checkpoint_dir")),
                    test_csv=_data_file(fn, reader, "_smiles.csv"),
                    truth_csv=_data_file(fn, reader, "_true.csv"))
        golden = name[len("test_"):].replace("_golden", "")
        out[golden] = G.Golden(golden, fn.lineno, train, band, **kw)
    return base, out


def test_table_matches_test_integration():
    base, want = integration_goldens()
    assert len(want) == 25
    assert G.TRAIN_BASE == base
    assert list(G.GOLDENS) == list(want)
    for name, g in G.GOLDENS.items():
        assert g == want[name], name
    # every band holds the reference value itself, and the deviation is
    # taken from the reference's own number
    for g in G.GOLDENS.values():
        assert g.ref in [c[1] for c in g.band]


def test_bands_hold_as_the_tests_state_them():
    g = G.GOLDENS["regression"]
    assert g.passes(1.237620 * 1.049) and not g.passes(1.237620 * 1.051)
    assert not g.passes(float("nan"))
    trip = G.GOLDENS["regression_roundtrip"]
    assert trip.ref == 0.561477
    assert trip.passes(0.4806 * 0.881) and not trip.passes(0.4806 * 0.879)
    # inside the torch band's top, over the reference's upper limit
    assert not trip.passes(0.5302 * 1.119)
    rf = G.GOLDENS["rf_roundtrip"]
    assert rf.passes(0.6878) and not rf.passes(0.6878 * 1.06)


def test_aliases_and_unknown_names():
    assert G.resolve("reg_rdkit") is G.GOLDENS["regression_rdkit"]
    assert G.resolve("cls_morgan") is G.GOLDENS["classification_morgan"]
    for name in ("reaction_morgan", "spectra_exclusions"):
        assert G.resolve(name) is G.GOLDENS[name]
    with pytest.raises(ValueError, match="unknown golden"):
        G.resolve("regression_nope")


def test_result_line_format():
    r = G.Result("regression", 1.25, 1.237620, True, 12.34, {}, {})
    assert r.line() == ("GOLDEN regression: 1.25 ref=1.23762 dev=+1.0% pass "
                        "12.3s")


# -- (b) scripts/tpu_goldens.py's four ---------------------------------------

def _tpu_goldens():
    spec = importlib.util.spec_from_file_location("tpu_goldens", TPU_GOLDENS)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("alias", list(G.ALIASES))
def test_tpu_goldens_configs_match(tmp_path, alias):
    tpu = _tpu_goldens()
    want = tpu.cfg_for(alias, str(tmp_path)).to_dict()
    got = G.train_config(G.resolve(alias), str(tmp_path), "cuda").to_dict()
    assert tpu.DATA == G.DATA
    shared = set(want) & set(got)
    assert set(got) - shared == {"device", "dist_backend"}
    assert {k: got[k] for k in shared} == want
    assert tpu.REFS[alias] == G.resolve(alias).ref
    assert set(tpu.REFS) == set(G.ALIASES)


# -- (c) reduced runs through both packages ----------------------------------

HELD = ("regression_morgan", "regression_rdkit", "regression_scaffold",
        "classification_rdkit", "classification_rdkit_live_generator",
        "classification_morgan", "reaction", "reaction_scaffold",
        "reaction_morgan", "spectra", "spectra_scaffold",
        "spectra_exclusions", "spectra_phase", "classification_roundtrip",
        "morgan_roundtrip", "rdkit_roundtrip")


def test_every_golden_is_held_somewhere():
    left_out = {"regression", "classification", "regression_roundtrip",
                "regression_rdkit_live_generator",
                "regression_graph_parallel", "rf", "rf_roundtrip", "svm",
                "svm_roundtrip"}
    assert set(HELD) | left_out == set(G.GOLDENS)
    assert not set(HELD) & left_out
    for name in left_out:
        assert name in __doc__


@pytest.fixture(scope="module")
def reduced_runs(tmp_path_factory):
    """One reduced ``cross_validate`` of each package per training
    configuration of ``HELD``: (port score, JAX score, port dir, JAX dir)."""
    from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
    from polymer_chemprop_tpu.train.cross_validate import (
        cross_validate as jax_cross_validate,
    )
    from polymer_chemprop_tpu_torch.train.cross_validate import (
        cross_validate,
    )
    root = tmp_path_factory.mktemp("reduced_goldens")
    cache = {}

    def run(g):
        key = repr(sorted(g.train.items()))
        if key not in cache:
            d = root / f"run{len(cache)}"
            port_dir, jax_dir = str(d / "port"), str(d / "jax")
            port = cross_validate(G.train_config(g, port_dir, "cpu",
                                                 **SMALL))[0]
            jax_ = jax_cross_validate(JaxTrainConfig(
                save_dir=jax_dir, **G.config_fields(g, **SMALL)))[0]
            cache[key] = (port, jax_, port_dir, jax_dir)
        return cache[key]
    return run


@pytest.mark.parametrize("name", HELD)
def test_reduced_golden_matches_jax_package(reduced_runs, tmp_path, name):
    g = G.GOLDENS[name]
    port, jax_, port_dir, jax_dir = reduced_runs(g)
    assert np.isfinite(port)
    np.testing.assert_allclose(port, jax_, rtol=RTOL)
    if not g.roundtrip:
        return
    from polymer_chemprop_tpu.config import PredictConfig as JaxPredictConfig
    from polymer_chemprop_tpu.train.make_predictions import (
        make_predictions as jax_make_predictions,
    )
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    pcfg = G.predict_config(g, port_dir, "cpu")
    pcfg.preds_path = str(tmp_path / "port.csv")
    got = np.asarray(make_predictions(pcfg), float)
    jcfg = {k: v for k, v in dataclasses.asdict(pcfg).items()
            if k not in ("device", "use_native_featurizer")}
    want = np.asarray(jax_make_predictions(JaxPredictConfig(**dict(
        jcfg, checkpoint_dir=jax_dir, preds_path=str(tmp_path / "jax.csv")))),
        float)
    assert got.shape == want.shape == G.read_truth(
        os.path.join(G.DATA, g.truth_csv)).shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    truth = os.path.join(G.DATA, g.truth_csv)
    np.testing.assert_allclose(G.roundtrip_mse(got, truth),
                               G.roundtrip_mse(want, truth), rtol=RTOL)


def test_graph_parallel_cli_arguments(tmp_path):
    """The gp golden's ``cli train`` arguments parse back to the same
    configuration, and its 2-rank launch runs on the CPU (reduced)."""
    from polymer_chemprop_tpu_torch.config import parse_train_args
    g = G.GOLDENS["regression_graph_parallel"]
    fields = G.config_fields(g, save_dir=str(tmp_path), device="cpu")
    assert parse_train_args(G.train_argv(fields)).to_dict() == \
        G.train_config(g, str(tmp_path), "cpu").to_dict()
    r = G.run_golden(g, "cpu", str(tmp_path / "gp"), **dict(SMALL, epochs=1))
    assert np.isfinite(r.score) and r.name == g.name
    # the plain versions count no launch
    assert not any(r.launches.values())


def test_cpu_roundtrip_and_baseline_through_run_golden(tmp_path):
    """``run_golden`` on the CPU at a reduced size: a round trip scores
    the truth file's present values, a baseline fits and predicts."""
    r = G.run_golden(G.GOLDENS["classification_roundtrip"], "cpu",
                     str(tmp_path / "cls"), **SMALL)
    assert 0 < r.score < 1 and r.ref == 0.064605
    r = G.run_golden(G.GOLDENS["svm_roundtrip"], "cpu", str(tmp_path / "svm"),
                     num_folds=1, max_data_size=60)
    assert np.isfinite(r.score) and r.seconds > 0


# -- (d) the full set on the card --------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the goldens run the "
                    "port's CUDA kernels at full width)")


@pytest.mark.gpu
@pytest.mark.golden
@pytest.mark.parametrize("name", list(G.GOLDENS))
def test_golden_on_the_card(cuda, tmp_path, name):
    r = G.run_golden(G.GOLDENS[name], "cuda", str(tmp_path / name))
    print(r.line())
    assert r.ok, r.line()
