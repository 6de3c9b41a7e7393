"""The port's random-forest and SVM baselines (``sklearn_train``,
``sklearn_predict``, ``baselines/``) against the JAX package's and
scikit-learn's, on the CPU:

* the JAX package's ``model.pkl`` of each of the four estimators, read by
  the port in a process where ``sklearn`` cannot be imported: predictions
  within 1e-9 relative of the JAX ``predict_sklearn``'s; the committed
  JAX-written files (``tests/data/sklearn_jax/``) against their CSVs;
* one tree against ``DecisionTreeRegressor(max_features=None)`` with the
  same bootstrap weights: node counts equal (less the nodes sklearn adds
  by splitting a node whose targets are all equal, which its rounding of
  ``Σ w y² / W - ȳ²`` allows and the port's centred impurity does not),
  in-bag predictions within 1e-12 relative;
* sklearn's ``max_features`` rule: constant draws count against it, and a
  node evaluates its first non-constant feature whatever its rank;
* the SVMs at the optimum (``tol=1e-8``: decision values within 1e-6; at
  the default tolerance within 5e-3), ``gamma`` equal, and libsvm's
  probability coupling on sklearn's own ``probA`` / ``probB`` equal to
  ``predict_proba`` within 1e-12;
* the forests statistically: 200 molecules, 50 trees, test RMSE within 5%
  of the JAX package's, classifier AUC within 0.03 (sklearn draws from its
  own random streams, so the forests differ tree by tree);
* imputation, the class weights, ``cross_validate`` with ``run_sklearn``
  and reading its ``model.pkl`` back, and the CLI's ``--device``.

The JAX fixtures are written by ``write_jax_fixtures`` below:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sklearn.py
"""

import csv
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from polymer_chemprop_tpu_torch import cli
from polymer_chemprop_tpu_torch.baselines import forest, pickles, svm, tree
from polymer_chemprop_tpu_torch.baselines.linear import linear_fit_predict
from polymer_chemprop_tpu_torch.config import PredictConfig
from polymer_chemprop_tpu_torch.features.generators import (
    morgan_binary_features_generator,
)
from polymer_chemprop_tpu_torch.sklearn_predict import predict_sklearn
from polymer_chemprop_tpu_torch.sklearn_train import (
    SklearnTrainConfig,
    impute_targets,
    run_sklearn,
)
from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
from test_torch_threads import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
REGRESSION = os.path.join(DATA, "regression.csv")
CLASSIFICATION = os.path.join(DATA, "classification.csv")
FIXTURES = os.path.join(DATA, "sklearn_jax")
CLASS_TASKS = ("NR-AhR", "SR-ARE")   # two tasks with enough positives

# name: (data, dataset_type, extra config); 10 trees, 256 bits, seed 0
FIXTURE_CASES = {
    "rf_regression": ("regression", "regression", {}),
    "svr": ("regression", "regression", {"model_type": "svm"}),
    "rf_classification": ("classification", "classification", {}),
    "svc": ("classification", "classification",
            {"model_type": "svm", "single_task": True}),
}


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _write_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _fixture_data(work_dir):
    """{data: (train csv, test csv)}: regression.csv's first 100 rows and
    the next 40; classification.csv's two ``CLASS_TASKS`` on the rows where
    both are labelled (so the forest takes the multi-output path), 100 and
    40 likewise."""
    os.makedirs(work_dir, exist_ok=True)
    out = {}
    header, rows = _read_csv(REGRESSION)
    head, rows_c = _read_csv(CLASSIFICATION)
    cols = [head.index(t) for t in CLASS_TASKS]
    both = [[r[0]] + [r[c] for c in cols] for r in rows_c
            if all(r[c] != "" for c in cols)]
    for name, hdr, data in (("regression", header, rows),
                            ("classification", ["smiles", *CLASS_TASKS],
                             both)):
        train = os.path.join(work_dir, f"{name}_train.csv")
        test = os.path.join(work_dir, f"{name}_test.csv")
        _write_csv(train, hdr, data[:100])
        _write_csv(test, ["smiles"], [[r[0]] for r in data[100:140]])
        out[name] = (train, test)
    return out


def write_jax_fixtures(out_dir, work_dir):
    """Fit the JAX package's four baselines (scikit-learn on the host) and
    write ``<name>.pkl`` (its model.pkl) and ``<name>_preds.csv`` (its
    ``predict_sklearn`` on 40 other molecules) into ``out_dir``."""
    import sklearn

    from polymer_chemprop_tpu.config import PredictConfig as JaxPredict
    from polymer_chemprop_tpu.sklearn_predict import predict_sklearn as jp
    from polymer_chemprop_tpu.sklearn_train import SklearnTrainConfig as JC
    from polymer_chemprop_tpu.sklearn_train import run_sklearn as jrun
    from polymer_chemprop_tpu.train.cross_validate import cross_validate as jcv
    os.makedirs(out_dir, exist_ok=True)
    data = _fixture_data(work_dir)
    for name, (which, dtype, extra) in FIXTURE_CASES.items():
        save = os.path.join(work_dir, name)
        jcv(JC(data_path=data[which][0], dataset_type=dtype, num_folds=1,
               seed=0, num_bits=256, num_trees=10, save_dir=save,
               quiet=True, **extra), train_func=jrun)
        pkl = os.path.join(out_dir, f"{name}.pkl")
        shutil.copy(os.path.join(save, "fold_0", "model.pkl"), pkl)
        jp(JaxPredict(test_path=data[which][1], checkpoint_path=pkl,
                      preds_path=os.path.join(out_dir, f"{name}_preds.csv")))
    with open(os.path.join(out_dir, "README"), "w") as f:
        f.write(
            "model.pkl files of the JAX package's sklearn_train (random "
            "forest and SVR on\nregression.csv's first 100 rows; random "
            f"forest and SVC on classification.csv's\n{' and '.join(CLASS_TASKS)} "
            "where both are labelled, first 100 rows; 10 trees, Morgan\n"
            "radius 2, 256 bits, seed 0), and its predict_sklearn on the "
            "next 40 molecules.\n"
            f"Written with scikit-learn {sklearn.__version__} and numpy "
            f"{np.__version__} by\nwrite_jax_fixtures in "
            "tests/test_torch_sklearn.py:\n\n"
            "    JAX_PLATFORMS=cpu PYTHONPATH=. python "
            "tests/test_torch_sklearn.py\n")


def _preds(path):
    header, rows = _read_csv(path)
    return [r[0] for r in rows], np.array([[float(v) for v in r[1:]]
                                           for r in rows])


def _morgan(path, n=None, bits=2048):
    header, rows = _read_csv(path)
    rows = rows[:n]
    X = np.stack([morgan_binary_features_generator(r[0], num_bits=bits)
                  for r in rows])
    return X, header, rows


@pytest.fixture(scope="module")
def reg_data():
    X, _, rows = _morgan(REGRESSION)
    return X, np.array([float(r[1]) for r in rows])


@pytest.fixture(scope="module")
def cls_data():
    X, header, rows = _morgan(CLASSIFICATION, 260)
    col = header.index("NR-AhR")
    ok = np.array([r[col] != "" for r in rows])
    return X[ok], np.array([float(r[col]) for r in np.array(rows)[ok]])


# ---------------------------------------------------------------------------
# model.pkl
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fresh_jax_pickles(tmp_path_factory):
    """The JAX package's four model.pkl files written now, and the port's
    predictions from them in a process where sklearn cannot be imported."""
    pytest.importorskip("sklearn")
    tmp = tmp_path_factory.mktemp("jax_sklearn")
    out, work = str(tmp / "out"), str(tmp / "work")
    write_jax_fixtures(out, work)
    cases = {name: (os.path.join(out, f"{name}.pkl"),
                    os.path.join(out, f"{name}_preds.csv"))
             for name in FIXTURE_CASES}
    code = (
        "import json, sys\n"
        "sys.modules['sklearn'] = None\n"
        "from polymer_chemprop_tpu_torch.config import PredictConfig\n"
        "from polymer_chemprop_tpu_torch.sklearn_predict import "
        "predict_sklearn\n"
        f"cases = {cases!r}\n"
        "out = {n: predict_sklearn(PredictConfig(test_path=c, "
        "checkpoint_path=p, device='cpu')) for n, (p, c) in cases.items()}\n"
        "out['loaded'] = [m for m, v in sys.modules.items() if "
        "m.split('.')[0] == 'sklearn' and v is not None]\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return cases, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(FIXTURE_CASES))
def test_jax_pickles_read_without_sklearn(fresh_jax_pickles, name):
    cases, port = fresh_jax_pickles
    assert port["loaded"] == []
    _, want = _preds(cases[name][1])
    np.testing.assert_allclose(np.array(port[name]), want, rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("name", list(FIXTURE_CASES))
def test_committed_jax_fixtures(name):
    pkl = os.path.join(FIXTURES, f"{name}.pkl")
    preds_csv = os.path.join(FIXTURES, f"{name}_preds.csv")
    smiles, want = _preds(preds_csv)
    got = predict_sklearn(PredictConfig(test_path=preds_csv,
                                        checkpoint_path=pkl, device="cpu"))
    np.testing.assert_allclose(np.array(got), want, rtol=1e-9, atol=1e-12)
    before = set(sys.modules)
    models, config, num_tasks = pickles.from_jax_bundle(pkl, "cpu")
    assert not [m for m in set(sys.modules) - before
                if m.split(".")[0] == "sklearn"]
    assert num_tasks == want.shape[1] and config["num_bits"] == 256
    assert len(models) == (2 if name == "svc" else 1)


def test_committed_fixtures_are_small():
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total <= 1 << 20, total


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


def test_reader_refuses_globals_outside_the_allow_list(tmp_path):
    path = tmp_path / "model.pkl"
    path.write_bytes(pickle.dumps({"models": [_Evil()]}))
    with pytest.raises(pickle.UnpicklingError, match="system is not allowed"):
        pickles.load_pickle(str(path))
    # a scikit-learn class that is not a forest, a tree or an SVM
    linear_model = pytest.importorskip("sklearn.linear_model")
    path.write_bytes(pickle.dumps({"models": [
        linear_model.LinearRegression()]}))
    with pytest.raises(pickle.UnpicklingError, match="LinearRegression"):
        pickles.load_pickle(str(path))


def test_port_pickle_holds_only_numpy_globals(tmp_path, reg_data):
    X, y = reg_data
    models = [forest.RandomForestRegressor(3, device="cpu").fit(X[:60],
                                                                y[:60]),
              svm.SVC(probability=True, device="cpu").fit(
                  X[:60], (y[:60] > np.median(y[:60])).astype(float))]
    path = str(tmp_path / "model.pkl")
    pickles.save_bundle(path, models, {"num_bits": 2048}, 1)
    seen = set()

    class Recorder(pickles.RestrictedUnpickler):
        def find_class(self, module, name):
            seen.add(module.split(".")[0])
            return super().find_class(module, name)

    with open(path, "rb") as f:
        bundle = Recorder(f).load()
    assert seen == {"numpy"} and bundle["format"] == pickles.FORMAT
    back, _, _ = pickles.load_bundle(path, "cpu")
    np.testing.assert_array_equal(back[0].predict(X[60:90]),
                                  models[0].predict(X[60:90]))
    np.testing.assert_array_equal(back[1].predict_proba(X[60:90]),
                                  models[1].predict_proba(X[60:90]))


# ---------------------------------------------------------------------------
# trees and forests
# ---------------------------------------------------------------------------

def _equal_target_splits(sk_tree, X, Y):
    """sklearn's internal nodes whose in-bag targets are all equal."""
    path = sk_tree.decision_path(X).tocsc()
    left = sk_tree.tree_.children_left
    n = 0
    for node in np.nonzero(left != -1)[0]:
        rows = path[:, node].nonzero()[0]
        n += bool((Y[rows] == Y[rows[0]]).all())
    return n


@pytest.mark.parametrize("n_outputs", [1, 2])
@pytest.mark.parametrize("seed", [0, 7])
def test_one_tree_matches_sklearn(reg_data, seed, n_outputs):
    DecisionTreeRegressor = pytest.importorskip(
        "sklearn.tree").DecisionTreeRegressor
    X, y = reg_data
    rng = np.random.default_rng(seed)
    w = np.bincount(rng.integers(0, len(y), len(y)),
                    minlength=len(y)).astype(float)
    Y = y[:, None] if n_outputs == 1 else np.stack(
        [y, np.sin(3 * y) + rng.normal(0, 0.1, len(y))], 1)
    grown = tree.grow_forest(torch.as_tensor(X.astype(np.uint8)),
                             torch.as_tensor(Y), torch.as_tensor(w)[None],
                             torch.tensor([12345]), "mse", n_outputs)
    sk = DecisionTreeRegressor(max_features=None, random_state=seed).fit(
        X, Y if n_outputs > 1 else y, sample_weight=w)
    inbag = w > 0
    extra = _equal_target_splits(sk, X[inbag], Y[inbag])
    assert int(grown.offsets[-1]) == sk.tree_.node_count - 2 * extra
    got = tree.leaf_values(grown, torch.as_tensor(X[inbag]))[:, :, 0]
    np.testing.assert_allclose(got.numpy(),
                               sk.predict(X[inbag]).reshape(-1, n_outputs),
                               rtol=1e-12, atol=1e-12)


def test_max_features_counts_constant_draws():
    """Keys ranked 0..F-1 in a random order; max_features 45."""
    F, m = 64, 45
    rng = np.random.default_rng(0)
    nonconst_ranks = {0: [60, 62], 1: [3, 44, 45], 2: [44], 3: [45]}
    keys, nodes, ranks, kth = [], [], [], []
    for node, rs in nonconst_ranks.items():
        feat_of_rank = rng.permutation(F)
        kth.append(44 * F + feat_of_rank[44])
        for r in rs:
            keys.append(r * F + feat_of_rank[r])
            nodes.append(node)
            ranks.append(r)
    ev = tree.sampled_candidates(torch.tensor(keys), torch.tensor(nodes),
                                 torch.tensor(kth), len(nonconst_ranks))
    evaluated = {(n, r) for n, r, e in zip(nodes, ranks, ev.tolist()) if e}
    # node 0: the 45 first draws are constant, so the first non-constant
    # one (rank 60) is evaluated and the search stops there; node 1: the
    # constant draws count, so rank 45 is the 46th visit and is not
    assert evaluated == {(0, 60), (1, 3), (1, 44), (2, 44), (3, 45)}


def test_a_node_evaluates_its_first_non_constant_feature():
    """With max_features 1 and one non-constant feature among 64, every
    tree still splits on it."""
    rng = np.random.default_rng(1)
    X = np.zeros((40, 64), np.uint8)
    X[:, 7] = rng.integers(0, 2, 40)
    X[:, 20] = 1
    y = X[:, 7] * 2.0 + 1.0
    grown = tree.grow_forest(torch.as_tensor(X), torch.as_tensor(y[:, None]),
                             torch.ones((5, 40), dtype=torch.float64),
                             torch.arange(5), "mse", 1, max_features=1)
    assert grown.feature[grown.offsets[:-1]].tolist() == [7] * 5
    assert torch.diff(grown.offsets).tolist() == [3] * 5


def test_feature_keys_are_distinct_and_device_free():
    node = torch.arange(50)[:, None]
    keys = tree.feature_keys(torch.full((50, 1), 2**32 - 1), node,
                             torch.arange(2048)[None], 2048)
    assert all(len(set(r.tolist())) == 2048 for r in keys)
    assert int(keys.max()) < 2**43 and int(keys.min()) >= 0


def test_balanced_weights_match_sklearn():
    compute_sample_weight = pytest.importorskip(
        "sklearn.utils.class_weight").compute_sample_weight
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, (60, 2))
    idx = rng.integers(0, 60, 60)
    np.testing.assert_allclose(forest.balanced_weights(y),
                               compute_sample_weight("balanced", y))
    np.testing.assert_allclose(
        forest.balanced_weights(y[:, :1], idx),
        compute_sample_weight("balanced", y[:, 0], indices=idx))


def test_forest_is_seeded_and_averages_its_trees(reg_data):
    X, y = reg_data
    a = forest.RandomForestRegressor(8, random_state=3, device="cpu").fit(
        X[:100], y[:100])
    b = forest.RandomForestRegressor(8, random_state=3, device="cpu").fit(
        X[:100], y[:100])
    for s, t in zip(a.tensors(), b.tensors()):
        assert torch.equal(s, t)
    leaves = tree.apply(a.forest_, torch.as_tensor(X[100:120]))
    by_tree = a.forest_.value[leaves][:, :, 0, 0]
    np.testing.assert_allclose(a.predict(X[100:120]),
                               by_tree.mean(0).numpy(), rtol=1e-15)
    with pytest.raises(ValueError, match="binary"):
        forest.RandomForestRegressor(2, device="cpu").fit(X[:10] * 0.5,
                                                          y[:10])


def _jax_and_port(tmp_path, **kw):
    pytest.importorskip("sklearn")
    from polymer_chemprop_tpu.sklearn_train import SklearnTrainConfig as JC
    from polymer_chemprop_tpu.sklearn_train import run_sklearn as jrun
    from polymer_chemprop_tpu.train.cross_validate import cross_validate as jcv
    jax_mean, _ = jcv(JC(save_dir=str(tmp_path / "jax"), quiet=True, **kw),
                      train_func=jrun)
    port_mean, _ = cross_validate(
        SklearnTrainConfig(save_dir=str(tmp_path / "port"), quiet=True,
                           device="cpu", **kw), train_func=run_sklearn)
    return jax_mean, port_mean


def test_forest_regression_score_near_jax(tmp_path):
    jax_rmse, port_rmse = _jax_and_port(
        tmp_path, data_path=REGRESSION, dataset_type="regression",
        max_data_size=200, num_trees=50, seed=0)
    assert abs(port_rmse - jax_rmse) / jax_rmse < 0.05, (port_rmse, jax_rmse)


def test_forest_classification_auc_near_jax(tmp_path):
    jax_auc, port_auc = _jax_and_port(
        tmp_path, data_path=CLASSIFICATION, dataset_type="classification",
        max_data_size=200, num_trees=50, seed=0)
    assert abs(port_auc - jax_auc) < 0.03, (port_auc, jax_auc)


# ---------------------------------------------------------------------------
# SVMs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tol,atol", [(1e-8, 1e-6), (1e-3, 5e-3)])
def test_svr_matches_sklearn(reg_data, tol, atol):
    SVR = pytest.importorskip("sklearn.svm").SVR
    X, y = reg_data
    port = svm.SVR(tol=tol, device="cpu").fit(X[:150], y[:150])
    sk = SVR(tol=tol).fit(X[:150], y[:150])
    assert port.gamma_ == sk._gamma
    np.testing.assert_allclose(port.predict(X[150:250]),
                               sk.predict(X[150:250]), rtol=0, atol=atol)


@pytest.mark.parametrize("tol,atol", [(1e-8, 1e-6), (1e-3, 5e-3)])
def test_svc_matches_sklearn(cls_data, tol, atol):
    SVC = pytest.importorskip("sklearn.svm").SVC
    X, y = cls_data
    port = svm.SVC(tol=tol, device="cpu").fit(X[:150], y[:150])
    sk = SVC(tol=tol).fit(X[:150], y[:150])
    assert port.gamma_ == sk._gamma
    np.testing.assert_allclose(port.decision_function(X[150:]),
                               sk.decision_function(X[150:]), rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(port.predict(X[150:]), sk.predict(X[150:]))


def test_probability_coupling_is_libsvms(cls_data):
    import warnings
    SVC = pytest.importorskip("sklearn.svm").SVC
    X, y = cls_data
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        sk = SVC(probability=True, random_state=0).fit(X[:150], y[:150])
    internal = torch.as_tensor(-sk.decision_function(X[150:]))
    r = svm.pairwise_probability(internal, float(sk.probA_[0]),
                                 float(sk.probB_[0]))
    np.testing.assert_allclose(svm.couple_two(r).numpy(),
                               sk.predict_proba(X[150:]), rtol=0, atol=1e-12)
    # the sigmoid alone is not sklearn's answer
    assert np.abs(r.numpy() - sk.predict_proba(X[150:])[:, 0]).max() > 1e-4


def test_svc_probabilities_are_seeded(cls_data):
    X, y = cls_data
    a = svm.SVC(probability=True, random_state=4, device="cpu").fit(
        X[:120], y[:120])
    b = svm.SVC(probability=True, random_state=4, device="cpu").fit(
        X[:120], y[:120])
    assert (a.probA_, a.probB_) == (b.probA_, b.probB_)
    p = a.predict_proba(X[120:])
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-12)
    assert a.platt_n_iter_ > 0 and a.n_iter_ > 0


# ---------------------------------------------------------------------------
# sklearn_train / sklearn_predict
# ---------------------------------------------------------------------------

def _targets_with_gaps():
    header, rows = _read_csv(CLASSIFICATION)
    rows = rows[:120]
    X = np.stack([morgan_binary_features_generator(r[0]) for r in rows])
    y = [[None if v == "" else float(v) for v in r[1:4]] for r in rows]
    return X, y


@pytest.mark.parametrize("mode", ["median", "mean", "frequent", "linear",
                                  "single_task"])
def test_impute_targets_match_jax(mode):
    pytest.importorskip("sklearn")
    from polymer_chemprop_tpu.sklearn_train import SklearnTrainConfig as JC
    from polymer_chemprop_tpu.sklearn_train import impute_targets as jimpute
    X, y = _targets_with_gaps()
    kw = dict(dataset_type="regression", model_type="svm", impute_mode=mode)
    got = impute_targets(X, y, SklearnTrainConfig(device="cpu", **kw))
    want = jimpute(X, y, JC(**kw))
    if mode in ("median", "mean", "frequent"):
        np.testing.assert_array_equal(got, want)
    elif mode == "linear":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


def test_linear_fit_is_minimum_norm():
    LinearRegression = pytest.importorskip(
        "sklearn.linear_model").LinearRegression
    X, _ = _targets_with_gaps()
    y = np.random.default_rng(0).normal(size=len(X))
    got = linear_fit_predict(X[:80], y[:80], X[80:], "cpu")
    want = LinearRegression().fit(X[:80], y[:80]).predict(X[80:])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def _two_task_csv(tmp_path):
    header, rows = _read_csv(CLASSIFICATION)
    cols = [header.index(t) for t in CLASS_TASKS]
    path = str(tmp_path / "two_tasks.csv")
    _write_csv(path, ["smiles", *CLASS_TASKS],
               [[r[0]] + [r[c] for c in cols] for r in rows
                if all(r[c] != "" for c in cols)][:120])
    return path


@pytest.mark.parametrize("case", ["rf_regression", "svr",
                                  "rf_classification", "svc"])
def test_cross_validate_writes_a_model_that_reads_back(tmp_path, case):
    which, dtype, extra = FIXTURE_CASES[case]
    data = REGRESSION if which == "regression" else _two_task_csv(tmp_path)
    save = str(tmp_path / "run")
    cfg = SklearnTrainConfig(data_path=data, dataset_type=dtype,
                             max_data_size=120, num_trees=10, num_folds=2,
                             save_dir=save, save_preds=True, quiet=True,
                             device="cpu", **extra)
    cross_validate(cfg, train_func=run_sklearn)
    for fold in range(2):
        fold_dir = os.path.join(save, f"fold_{fold}")
        with open(os.path.join(fold_dir, "test_scores.json")) as f:
            assert cfg.metric in json.load(f)
        _, want = _preds(os.path.join(fold_dir, "test_preds.csv"))
        out = str(tmp_path / f"preds_{fold}.csv")
        got = predict_sklearn(PredictConfig(
            test_path=os.path.join(fold_dir, "test_preds.csv"),
            checkpoint_path=os.path.join(fold_dir, "model.pkl"),
            preds_path=out, device="cpu"))
        np.testing.assert_allclose(np.array(got), want, rtol=1e-12,
                                   atol=1e-15)
        assert _preds(out)[1].shape == want.shape


def test_multitask_svm_needs_single_task(tmp_path):
    cfg = SklearnTrainConfig(data_path=_two_task_csv(tmp_path),
                             dataset_type="classification", model_type="svm",
                             max_data_size=60, quiet=True, device="cpu")
    with pytest.raises(ValueError, match="1d array"):
        cross_validate(cfg, train_func=run_sklearn)


def test_cli_sklearn_runs_on_the_cpu_and_defaults_to_cuda(tmp_path):
    save = str(tmp_path / "cli")
    args = ["--data_path", REGRESSION, "--dataset_type", "regression",
            "--max_data_size", "60", "--num_trees", "4", "--save_dir", save,
            "--quiet"]
    cli.main(["sklearn_train", *args, "--device", "cpu"])
    assert os.path.exists(os.path.join(save, "fold_0", "model.pkl"))
    preds = str(tmp_path / "preds.csv")
    cli.main(["sklearn_predict", "--test_path", REGRESSION,
              "--checkpoint_dir", save, "--preds_path", preds,
              "--device", "cpu"])
    assert len(_preds(preds)[0]) == 500
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["sklearn_train", *args])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["sklearn_predict", "--test_path", REGRESSION,
                  "--checkpoint_dir", save])


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as work:
        write_jax_fixtures(FIXTURES, work)
