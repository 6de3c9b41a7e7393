"""Random forests on the card: the counterparts of scikit-learn's
``RandomForestRegressor`` and ``RandomForestClassifier`` as the JAX
package builds them (polymer_chemprop_tpu/sklearn_train.py:83-97: 500
trees, bootstrap, ``max_features`` 1.0 for the regressor and ``"sqrt"``
for the classifier, ``class_weight`` for the classifier).

Every tree is grown by baselines/tree.py, all trees of a forest at once.
The random draws come from a ``torch.Generator`` on the CPU: tree i's
generator is seeded from ``(random_state, i)`` (numpy's ``SeedSequence``)
and draws its bootstrap (n rows with replacement, so the sample weights
are bincounts) and the seed of its feature keys. The draws then move to
the device, so one seed grows the same forest on the card and on the CPU.
sklearn's draws come from its own MT19937 streams: the port's forest at a
seed is another forest from the same distribution, not sklearn's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .tree import Forest, grow_forest, leaf_values


def binary_features(X: np.ndarray, device) -> torch.Tensor:
    """(n, F) uint8 bits on ``device``; raises unless every entry is 0 or 1
    (the trees split each feature at 0.5)."""
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D, got shape {X.shape}")
    if not np.isin(X, (0, 1)).all():
        raise ValueError("the port's forests take binary features (0 or 1), "
                         "such as Morgan bits")
    return torch.as_tensor(X.astype(np.uint8), device=device)


def _as_float(X: np.ndarray, n_features: int, device) -> torch.Tensor:
    X = np.asarray(X, dtype=np.float64)
    if X.ndim != 2 or X.shape[1] != n_features:
        raise ValueError(f"X has shape {X.shape}; the model takes "
                         f"{n_features} features")
    return torch.as_tensor(X, device=device)


def tree_generator(seed: int, i: int) -> torch.Generator:
    """Tree i's CPU generator, seeded from (seed, i)."""
    state = np.random.SeedSequence([int(seed), int(i)]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) | int(state[1]) << 32)


def bootstrap(n: int, n_trees: int, seed: int):
    """Each tree's bootstrap indices (T, n) and feature-key seed (T,), from
    tree i's generator."""
    idx = torch.empty((n_trees, n), dtype=torch.int64)
    seeds = torch.empty(n_trees, dtype=torch.int64)
    for i in range(n_trees):
        g = tree_generator(seed, i)
        idx[i] = torch.randint(n, (n,), generator=g)
        seeds[i] = torch.randint(1 << 32, (1,), generator=g)[0]
    return idx, seeds


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    rows = torch.arange(idx.shape[0])[:, None].expand_as(idx)
    out = torch.zeros((idx.shape[0], n), dtype=torch.float64)
    out.index_put_((rows.reshape(-1), idx.reshape(-1)),
                   torch.ones(idx.numel(), dtype=torch.float64),
                   accumulate=True)
    return out


def balanced_weights(y_enc: np.ndarray, indices: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    """sklearn's ``compute_sample_weight("balanced", y, indices=...)`` on
    class indices ``y_enc`` (n, K): per output, n_sub / (classes present x
    count) from the rows ``indices`` (all rows when None); rows of a class
    missing from those rows get 0; the outputs multiply."""
    out = np.ones(len(y_enc))
    for k in range(y_enc.shape[1]):
        col = y_enc[:, k]
        sub = col if indices is None else col[indices]
        present, counts = np.unique(sub, return_counts=True)
        per_class = len(sub) / (len(present) * counts.astype(np.float64))
        weight = np.zeros(int(col.max()) + 1)
        weight[present] = per_class
        out = out * weight[col]
    return out


class _Forest:
    criterion = "mse"

    def __init__(self, n_estimators: int = 100, random_state: int = 0,
                 max_features: Union[float, str, None] = 1.0,
                 device="cuda"):
        self.n_estimators = n_estimators
        self.random_state = random_state
        self.max_features = max_features
        self.device = torch.device(device)
        self.forest_: Optional[Forest] = None

    def _n_drawn(self, n_features: int) -> int:
        m = self.max_features
        if m is None:
            return n_features
        if m == "sqrt":
            return max(1, int(np.sqrt(n_features)))
        if isinstance(m, float):
            return max(1, int(m * n_features))
        return int(m)

    def _grow(self, X, Y: np.ndarray, n_outputs: int,
              sample_weight: Optional[np.ndarray] = None,
              subsample_classes: Optional[np.ndarray] = None) -> None:
        """Grow the trees; ``sample_weight`` multiplies every tree's
        bootstrap counts, and with ``subsample_classes`` (class indices)
        each tree's weights are balanced on its own bootstrap too."""
        bits = binary_features(X, self.device)
        n = bits.shape[0]
        idx, seeds = bootstrap(n, self.n_estimators, self.random_state)
        weights = _counts(idx, n)
        if sample_weight is not None:
            weights = weights * torch.as_tensor(sample_weight)[None]
        if subsample_classes is not None:
            weights = weights * torch.as_tensor(np.stack(
                [balanced_weights(subsample_classes, i) for i in idx.numpy()]))
        self.n_features_in_ = bits.shape[1]
        self.n_outputs_ = n_outputs
        self.forest_ = grow_forest(
            bits, torch.as_tensor(Y, dtype=torch.float64, device=self.device),
            weights.to(self.device), seeds.to(self.device), self.criterion,
            n_outputs, self._n_drawn(bits.shape[1]))

    def _leaf_values(self, X) -> torch.Tensor:
        return leaf_values(self.forest_,
                           _as_float(X, self.n_features_in_, self.device))

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self.forest_, f) for f in
                ("offsets", "left", "right", "feature", "value")]

    def _state(self) -> Dict:
        return {"kind": type(self).__name__,
                "forest": self.forest_.to_state(),
                "n_estimators": self.n_estimators,
                "random_state": self.random_state,
                "max_features": self.max_features,
                "n_features_in": self.n_features_in_,
                "n_outputs": self.n_outputs_}

    def _load(self, state: Dict) -> None:
        self.forest_ = Forest.from_state(state["forest"], self.device)
        self.n_features_in_ = int(state["n_features_in"])
        self.n_outputs_ = int(state["n_outputs"])


class RandomForestRegressor(_Forest):
    """Squared-error forest; ``predict`` averages the trees' leaf means."""

    criterion = "mse"

    def fit(self, X, y) -> "RandomForestRegressor":
        y = np.asarray(y, dtype=np.float64)
        Y = y[:, None] if y.ndim == 1 else y
        self._grow(X, Y, Y.shape[1])
        return self

    def predict(self, X) -> np.ndarray:
        out = self._leaf_values(X)[:, :, 0].cpu().numpy()
        return out[:, 0] if self.n_outputs_ == 1 else out

    def to_state(self) -> Dict:
        return self._state()

    @classmethod
    def from_state(cls, state: Dict, device) -> "RandomForestRegressor":
        model = cls(state["n_estimators"], state["random_state"],
                    state["max_features"], device)
        model._load(state)
        return model


class RandomForestClassifier(_Forest):
    """Gini forest; ``predict_proba`` averages the trees' leaf class
    fractions (one array a output when there are several)."""

    criterion = "gini"

    def __init__(self, n_estimators: int = 100, random_state: int = 0,
                 class_weight: Optional[str] = None,
                 max_features: Union[float, str, None] = "sqrt",
                 device="cuda"):
        if class_weight not in (None, "balanced", "balanced_subsample"):
            raise ValueError(f"class_weight {class_weight!r}: None, "
                             "'balanced' or 'balanced_subsample'")
        super().__init__(n_estimators, random_state, max_features, device)
        self.class_weight = class_weight

    def fit(self, X, y) -> "RandomForestClassifier":
        y = np.asarray(y)
        y2 = y[:, None] if y.ndim == 1 else y
        self.classes_ = [np.unique(y2[:, k]) for k in range(y2.shape[1])]
        y_enc = np.stack([np.searchsorted(c, y2[:, k])
                          for k, c in enumerate(self.classes_)], 1)
        C = max(len(c) for c in self.classes_)
        K = y2.shape[1]
        Y = np.zeros((len(y2), K * C))
        Y[np.arange(len(y2))[:, None], np.arange(K) * C + y_enc] = 1.0
        self._grow(X, Y, K,
                   sample_weight=balanced_weights(y_enc)
                   if self.class_weight == "balanced" else None,
                   subsample_classes=y_enc
                   if self.class_weight == "balanced_subsample" else None)
        return self

    def predict_proba(self, X) -> Union[np.ndarray, List[np.ndarray]]:
        vals = self._leaf_values(X).cpu().numpy()
        proba = [vals[:, k, :len(c)] for k, c in enumerate(self.classes_)]
        return proba[0] if self.n_outputs_ == 1 else proba

    def predict(self, X) -> np.ndarray:
        proba = self.predict_proba(X)
        if self.n_outputs_ == 1:
            return self.classes_[0][np.argmax(proba, axis=1)]
        return np.stack([c[np.argmax(p, axis=1)]
                         for c, p in zip(self.classes_, proba)], 1)

    def to_state(self) -> Dict:
        state = self._state()
        state.update(class_weight=self.class_weight,
                     classes=[np.asarray(c) for c in self.classes_])
        return state

    @classmethod
    def from_state(cls, state: Dict, device) -> "RandomForestClassifier":
        model = cls(state["n_estimators"], state["random_state"],
                    state["class_weight"], state["max_features"], device)
        model._load(state)
        model.classes_ = [np.asarray(c) for c in state["classes"]]
        return model
