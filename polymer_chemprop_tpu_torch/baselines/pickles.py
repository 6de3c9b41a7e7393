"""Reading and writing the baselines' ``model.pkl``, without scikit-learn.

Two formats:

* the JAX package's: ``pickle.dump({"models", "config", "num_tasks"})``
  of fitted scikit-learn estimators (polymer_chemprop_tpu/
  sklearn_train.py:150-156). A fitted forest or SVM pickles as plain
  numpy state, so a restricted ``pickle.Unpickler`` reads it: its
  ``find_class`` maps the estimators' classes to small stub classes that
  keep their constructor arguments and their ``__setstate__`` dict, and
  numpy's array reconstructors to numpy's own. Any other global raises
  ``UnpicklingError``. Nothing goes into ``sys.modules``: sklearn is never
  imported, and no stub stands in for it there. ``from_jax_bundle``
  turns the stubs into the port's estimators on a device.
* the port's own: a pickle of plain dicts, lists, strings, numbers and
  numpy arrays, tagged ``"format": FORMAT`` (``save_bundle``); the same
  restricted reader reads it. The JAX package's ``predict_sklearn`` cannot
  read it.

A sklearn ``Tree`` pickles as a reduce of ``(n_features, n_classes,
n_outputs)`` and a state with ``nodes`` (a structured array: left_child,
right_child, feature, threshold, impurity, n_node_samples,
weighted_n_node_samples and, from sklearn 1.3, missing_go_to_left) and
``values`` ``(node_count, n_outputs, max_n_classes)``. Leaves have
``left_child == -1``; a row goes left when ``x[feature] <= threshold``.
Classifier values are class fractions from sklearn 1.4 and weighted
counts before; each leaf is normalised, so both read the same.
"""

from __future__ import annotations

import io
import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch

from .forest import RandomForestClassifier, RandomForestRegressor
from .svm import SVC, SVR
from .tree import UNDEFINED, Forest

FORMAT = "polymer_chemprop_tpu_torch.baselines/1"

ESTIMATORS = ("RandomForestRegressor", "RandomForestClassifier",
              "DecisionTreeRegressor", "DecisionTreeClassifier", "Tree",
              "SVR", "SVC")


class SklearnStub:
    """A pickled scikit-learn object: its constructor arguments (``args``)
    and its state dict (``state``)."""

    def __init__(self, *args):
        self.args = args
        self.state: Dict = {}

    def __setstate__(self, state: Dict) -> None:
        self.state = state


STUBS = {name: type(name, (SklearnStub,), {}) for name in ESTIMATORS}


def _numpy_globals() -> Dict[Tuple[str, str], object]:
    """numpy's reconstructors under both ``numpy.core`` (numpy 1) and
    ``numpy._core`` (numpy 2), whichever numpy wrote the file."""
    core = getattr(np, "_core", None) or np.core
    found = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype}
    for prefix in ("numpy.core", "numpy._core"):
        found[(f"{prefix}.multiarray", "_reconstruct")] = \
            core.multiarray._reconstruct
        found[(f"{prefix}.multiarray", "scalar")] = core.multiarray.scalar
        found[(f"{prefix}.numeric", "_frombuffer")] = core.numeric._frombuffer
    return found


class RestrictedUnpickler(pickle.Unpickler):
    """Reads scikit-learn's forests and SVMs and numpy arrays; refuses every
    other global."""

    _numpy = _numpy_globals()

    def find_class(self, module: str, name: str):
        if (module, name) in self._numpy:
            return self._numpy[(module, name)]
        if module.split(".")[0] == "sklearn" and name in STUBS:
            return STUBS[name]
        raise pickle.UnpicklingError(
            f"global {module}.{name} is not allowed in a model.pkl")


def load_pickle(path: str):
    with open(path, "rb") as f:
        return RestrictedUnpickler(io.BytesIO(f.read())).load()


def save_bundle(path: str, models: List, config: Dict,
                num_tasks: int) -> None:
    """The port's model.pkl: plain dicts and numpy arrays."""
    bundle = {"format": FORMAT, "models": [m.to_state() for m in models],
              "config": config, "num_tasks": num_tasks}
    with open(path, "wb") as f:
        pickle.dump(bundle, f, protocol=4)


_PORT_CLASSES = {cls.__name__: cls for cls in
                 (RandomForestRegressor, RandomForestClassifier, SVR, SVC)}


def _read_bundle(path: str) -> Dict:
    bundle = load_pickle(path)
    if not isinstance(bundle, dict) or "models" not in bundle:
        raise ValueError(f"{path} is not a baseline model.pkl")
    return bundle


def _models(bundle: Dict, device) -> Tuple[List, Dict, int]:
    if bundle.get("format") == FORMAT:
        models = [_PORT_CLASSES[s["kind"]].from_state(s, device)
                  for s in bundle["models"]]
    else:
        models = [from_sklearn(m, device) for m in bundle["models"]]
    return models, bundle["config"], int(bundle["num_tasks"])


def from_jax_bundle(path: str, device) -> Tuple[List, Dict, int]:
    """A JAX-package model.pkl (``{"models", "config", "num_tasks"}`` of
    scikit-learn estimators) as (the port's estimators on ``device``, the
    config dict, num_tasks)."""
    bundle = _read_bundle(path)
    if bundle.get("format") == FORMAT:
        raise ValueError(f"{path} is the port's model.pkl, not the JAX "
                         "package's")
    return _models(bundle, device)


def load_bundle(path: str, device) -> Tuple[List, Dict, int]:
    """(models on ``device``, config dict, num_tasks) of a model.pkl in
    either format."""
    return _models(_read_bundle(path), device)


# ---------------------------------------------------------------------------
# sklearn state -> the port's estimators
# ---------------------------------------------------------------------------

def _forest_from_trees(trees: List[SklearnStub], device) -> Forest:
    """One flat ``Forest`` from sklearn ``Tree`` stubs."""
    parts = {f: [] for f in ("left", "right", "feature", "threshold",
                             "value", "n_node_samples",
                             "weighted_n_node_samples", "impurity")}
    counts, max_depth, base = [], 0, 0
    for tree in trees:
        nodes = tree.state["nodes"]
        values = np.asarray(tree.state["values"], dtype=np.float64)
        n = len(nodes)
        leaf = nodes["left_child"] == -1
        parts["left"].append(np.where(leaf, -1, nodes["left_child"] + base))
        parts["right"].append(np.where(leaf, -1,
                                       nodes["right_child"] + base))
        parts["feature"].append(np.where(leaf, UNDEFINED, nodes["feature"]))
        parts["threshold"].append(nodes["threshold"].astype(np.float64))
        parts["value"].append(values)
        for f in ("n_node_samples", "weighted_n_node_samples", "impurity"):
            parts[f].append(nodes[f])
        counts.append(n)
        max_depth = max(max_depth, int(tree.state["max_depth"]))
        base += n
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    state = {f: np.concatenate(v) for f, v in parts.items()}
    for f in ("left", "right", "feature", "n_node_samples"):
        state[f] = state[f].astype(np.int64)
    return Forest.from_state(dict(state, offsets=offsets,
                                  max_depth=max_depth), device)


def _normalise_leaves(forest: Forest, n_classes: List[int]) -> None:
    """Each output's leaf values as class fractions (sklearn < 1.4 stored
    weighted counts); a leaf with no weight keeps zeros."""
    v = forest.value
    for k, c in enumerate(n_classes):
        total = v[:, k, :c].sum(1, keepdim=True)
        v[:, k, :c] /= torch.where(total == 0, torch.ones_like(total), total)


def from_sklearn(stub: SklearnStub, device):
    """The port's estimator holding a pickled sklearn estimator's fit."""
    kind = type(stub).__name__
    s = stub.state
    if kind in ("RandomForestRegressor", "RandomForestClassifier"):
        trees = [e.state["tree_"] for e in s["estimators_"]]
        forest = _forest_from_trees(trees, device)
        n_features = int(s["n_features_in_"])
        n_outputs = int(s["n_outputs_"])
        if kind == "RandomForestRegressor":
            model = RandomForestRegressor(len(trees), device=device)
        else:
            model = RandomForestClassifier(
                len(trees), class_weight=s.get("class_weight"),
                device=device)
            classes = s["classes_"]
            model.classes_ = [np.asarray(c) for c in classes] \
                if n_outputs > 1 else [np.asarray(classes)]
            _normalise_leaves(forest, [len(c) for c in model.classes_])
        model.forest_ = forest
        model.n_features_in_ = n_features
        model.n_outputs_ = n_outputs
        return model
    if kind in ("SVR", "SVC"):
        if s.get("kernel", "rbf") != "rbf" or s.get("_sparse"):
            raise ValueError(f"only dense RBF {kind}s are read")
        if kind == "SVR":
            model = SVR(float(s["C"]), float(s["epsilon"]), float(s["tol"]),
                        device)
        else:
            model = SVC(float(s["C"]), float(s["tol"]),
                        bool(s["probability"]), device=device)
            model.classes_ = np.asarray(s["classes_"])
            if len(model.classes_) != 2:
                raise ValueError("only binary SVCs are read")
            if model.probability:
                model.probA_ = float(np.asarray(s["_probA"])[0])
                model.probB_ = float(np.asarray(s["_probB"])[0])
        model._load({
            "gamma": s["_gamma"],
            "intercept": np.asarray(s["_intercept_"])[0],
            "support_vectors": s["support_vectors_"],
            "dual_coef": np.asarray(s["_dual_coef_"])[0]})
        return model
    raise pickle.UnpicklingError(f"a model.pkl holds {kind}, not a forest "
                                 "or an SVM")
