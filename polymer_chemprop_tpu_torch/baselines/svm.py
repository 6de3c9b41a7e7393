"""RBF support vector machines on the card: the counterparts of
scikit-learn's ``SVR()`` and ``SVC(probability=True)`` as the JAX package
builds them (polymer_chemprop_tpu/sklearn_train.py:88-95), with libsvm's
solver and its probability estimates copied.

* ``gamma="scale"``: ``1 / (n_features * X.var())``, computed on the host
  in numpy as sklearn computes it, so the value is sklearn's.
* The kernel matrix: ``exp(-gamma (|x|² + |x'|² - 2 x x'))`` with the
  product by ``torch.matmul`` in float64. The solver reads it rounded to
  float32, as libsvm's kernel cache (``Qfloat``) holds it; decision values
  use the float64 kernel, as libsvm's ``k_function`` does.
* The solver is libsvm's ``Solver`` (``svm.cpp``): second-order working
  set selection (WSS2, ``TAU = 1e-12``; the last index wins a tie, as
  libsvm's ``>=`` and ``<=`` make it), the two-variable update with its
  bound clipping, a stop when the KKT gap ``Gmax + Gmax2`` falls below
  ``tol``, and ``rho`` as the mean of ``y G`` over the free variables,
  else the midpoint of its bounds. No shrinking: it changes the path, not
  the optimum within ``tol``. ``solve`` runs a batch of problems over one
  kernel matrix at once on the tensors' device, a few dozen tensor
  operations an iteration with no host sync; every ``CHECK_EVERY``
  iterations it reads whether all problems have stopped.
* SVR is the 2n-variable epsilon-SVR dual (``solve_epsilon_svr``); the
  binary C-SVC puts class 0 first and gives it label +1, as sklearn's
  libsvm (which sorts the labels) does, so the internal decision value
  ``K(x, SV) @ dual_coef + intercept`` leans to class 0 and sklearn's
  ``decision_function`` is its negation.
* Probabilities: libsvm's ``svm_binary_svc_probability``: decision values
  of 5-fold cross-validation (the five folds' problems solved as one
  batch), then ``sigmoid_train`` (Newton with backtracking on Platt's
  smoothed targets, on the host). The fold permutation comes from a CPU
  ``torch.Generator`` seeded with ``random_state``; sklearn leaves it
  unseeded in the JAX package. ``predict_proba`` applies
  ``sigmoid_predict`` in its stable form, clamps to ``[1e-7, 1 - 1e-7]``
  and runs libsvm's iterative ``multiclass_probability`` coupling, which
  sklearn's libsvm applies even to two classes.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

TAU = 1e-12
CHECK_EVERY = 64          # iterations between reads of the stop flags
MAX_ITER = 10_000_000     # libsvm's max(10000000, 100 l) for l < 100,000
MIN_PROB = 1e-7           # libsvm's clamp of pairwise probabilities
N_FOLDS = 5               # svm_binary_svc_probability's folds


def scale_gamma(X: np.ndarray) -> float:
    """sklearn's ``gamma="scale"``: 1 / (n_features * X.var())."""
    X = np.asarray(X, dtype=np.float64)
    var = X.var()
    return float(1.0 / (X.shape[1] * var)) if var != 0 else 1.0


def rbf_kernel(A: torch.Tensor, B: torch.Tensor, gamma: float
               ) -> torch.Tensor:
    """exp(-gamma |a - b|²) for every row pair, in float64."""
    d = (A * A).sum(1)[:, None] + (B * B).sum(1)[None] - 2.0 * (A @ B.T)
    return torch.exp(-gamma * d)


class Solution(NamedTuple):
    alpha: torch.Tensor    # (P, L) float64
    rho: torch.Tensor      # (P,) float64
    n_iter: torch.Tensor   # (P,) int64 iterations each problem took


def solve(Kq: torch.Tensor, rows: torch.Tensor, y: torch.Tensor,
          p: torch.Tensor, C: torch.Tensor, valid: torch.Tensor,
          tol: float) -> Solution:
    """libsvm's ``Solver::Solve`` (no shrinking) for P problems at once:
    minimise ``½ aᵀQa + pᵀa`` subject to ``yᵀa = 0``, ``0 <= a <= C``, with
    ``Q_ij = y_i y_j K[rows_i, rows_j]``.

    Kq:    (n, n) the kernel matrix, rounded to float32 (libsvm's Qfloat)
    rows:  (P, L) int64 row of Kq of each variable
    y:     (P, L) float64 +1 / -1
    p:     (P, L) float64 linear term
    C:     (P, L) float64 upper bound of each variable
    valid: (P, L) bool; padding variables are never selected
    """
    P, L = rows.shape
    dev = Kq.device
    f64 = torch.float64
    alpha = torch.zeros((P, L), dtype=f64, device=dev)
    G = p.clone()
    QD = torch.ones((P, L), dtype=f64, device=dev)  # K(x, x) = 1 for RBF
    bidx = torch.arange(P, device=dev)
    flip = torch.arange(L - 1, -1, -1, device=dev)
    active = torch.ones(P, dtype=torch.bool, device=dev)
    n_iter = torch.zeros(P, dtype=torch.int64, device=dev)
    pos = y > 0
    ninf = torch.tensor(-float("inf"), dtype=f64, device=dev)
    it = 0
    while it < MAX_ITER:
        for _ in range(CHECK_EVERY):
            upper = alpha >= C
            lower = alpha <= 0
            i_up = valid & torch.where(pos, ~upper, ~lower)
            i_low = valid & torch.where(pos, ~lower, ~upper)
            mG = -y * G
            # i: the last arg max of -y G over I_up
            v = torch.where(i_up, mG, ninf)
            i = (L - 1) - torch.argmax(v[:, flip], dim=1)
            Gmax = v[bidx, i]
            yi = y[bidx, i]
            Ki = Kq[rows[bidx, i]].gather(1, rows).to(f64)   # K[row_i, :]
            # j: the last arg min of -(Gmax - (-y G))² / quad over I_low
            Gmax2 = torch.where(i_low, -mG, ninf).amax(1)
            grad_diff = Gmax[:, None] - mG
            quad = QD[bidx, i][:, None] + QD - 2.0 * Ki
            quad = torch.where(quad > 0, quad, torch.full_like(quad, TAU))
            obj = torch.where(i_low & (grad_diff > 0),
                              -(grad_diff * grad_diff) / quad,
                              torch.full_like(quad, float("inf")))
            j = (L - 1) - torch.argmin(obj[:, flip], dim=1)
            found = torch.isfinite(obj[bidx, j])
            active = active & (Gmax + Gmax2 >= tol) & found
            n_iter += active
            yj = y[bidx, j]
            Kj = Kq[rows[bidx, j]].gather(1, rows).to(f64)
            Ci, Cj = C[bidx, i], C[bidx, j]
            ai, aj = alpha[bidx, i], alpha[bidx, j]
            Gi, Gj = G[bidx, i], G[bidx, j]
            Qij = yi * yj * Ki[bidx, j]
            new_i, new_j = _two_variable_update(
                yi != yj, QD[bidx, i], QD[bidx, j], Qij, Gi, Gj, ai, aj,
                Ci, Cj)
            dai = torch.where(active, new_i - ai, torch.zeros_like(ai))
            daj = torch.where(active, new_j - aj, torch.zeros_like(aj))
            alpha[bidx, i] = ai + dai
            alpha[bidx, j] = aj + daj
            # Q_i[k] = y_i y_k K_ik
            G += (yi[:, None] * y * Ki) * dai[:, None] \
                + (yj[:, None] * y * Kj) * daj[:, None]
        it += CHECK_EVERY
        if not bool(active.any()):
            break
    return Solution(alpha, _rho(alpha, G, y, C, valid), n_iter)


def _two_variable_update(diff_y, QDi, QDj, Qij, Gi, Gj, ai, aj, Ci, Cj):
    """libsvm's update of alpha_i, alpha_j with its clipping to the box,
    for both label cases, elementwise."""
    z = torch.zeros_like(ai)
    # y_i != y_j
    quad = QDi + QDj + 2.0 * Qij
    quad = torch.where(quad > 0, quad, torch.full_like(quad, TAU))
    delta = (-Gi - Gj) / quad
    diff = ai - aj
    a1, a2 = ai + delta, aj + delta
    c = (diff > 0) & (a2 < 0)
    a1, a2 = torch.where(c, diff, a1), torch.where(c, z, a2)
    c = (diff <= 0) & (a1 < 0)
    a1, a2 = torch.where(c, z, a1), torch.where(c, -diff, a2)
    c = (diff > Ci - Cj) & (a1 > Ci)
    a1, a2 = torch.where(c, Ci, a1), torch.where(c, Ci - diff, a2)
    c = (diff <= Ci - Cj) & (a2 > Cj)
    a1, a2 = torch.where(c, Cj + diff, a1), torch.where(c, Cj, a2)
    # y_i == y_j
    quad = QDi + QDj - 2.0 * Qij
    quad = torch.where(quad > 0, quad, torch.full_like(quad, TAU))
    delta = (Gi - Gj) / quad
    s = ai + aj
    b1, b2 = ai - delta, aj + delta
    c = (s > Ci) & (b1 > Ci)
    b1, b2 = torch.where(c, Ci, b1), torch.where(c, s - Ci, b2)
    c = (s <= Ci) & (b2 < 0)
    b1, b2 = torch.where(c, s, b1), torch.where(c, z, b2)
    c = (s > Cj) & (b2 > Cj)
    b1, b2 = torch.where(c, s - Cj, b1), torch.where(c, Cj, b2)
    c = (s <= Cj) & (b1 < 0)
    b1, b2 = torch.where(c, z, b1), torch.where(c, s, b2)
    return torch.where(diff_y, a1, b1), torch.where(diff_y, a2, b2)


def _rho(alpha, G, y, C, valid) -> torch.Tensor:
    """libsvm's ``calculate_rho``."""
    inf = float("inf")
    yG = y * G
    upper = valid & (alpha >= C)
    lower = valid & (alpha <= 0) & ~upper
    free = valid & ~upper & ~lower
    pos = y > 0
    to_ub = (upper & ~pos) | (lower & pos)
    to_lb = (upper & pos) | (lower & ~pos)
    ub = torch.where(to_ub, yG, torch.full_like(yG, inf)).amin(1)
    lb = torch.where(to_lb, yG, torch.full_like(yG, -inf)).amax(1)
    n_free = free.sum(1)
    mean_free = torch.where(free, yG, torch.zeros_like(yG)).sum(1) \
        / n_free.clamp(min=1)
    return torch.where(n_free > 0, mean_free, (ub + lb) / 2)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _SVM:
    def __init__(self, C: float = 1.0, tol: float = 1e-3, device="cuda"):
        self.C = float(C)
        self.tol = float(tol)
        self.device = torch.device(device)

    def _prepare(self, X) -> torch.Tensor:
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got shape {X.shape}")
        self.gamma_ = scale_gamma(X)
        return torch.as_tensor(X, device=self.device)

    def _kernel_q(self, X: torch.Tensor) -> torch.Tensor:
        return rbf_kernel(X, X, self.gamma_).to(torch.float32)

    def _keep_support(self, X: torch.Tensor, coef: torch.Tensor,
                      rho: torch.Tensor) -> None:
        sv = coef != 0
        self.support_vectors_ = X[sv]
        self.dual_coef_ = coef[sv]
        self.intercept_ = float(-rho)

    def decision_values(self, X) -> torch.Tensor:
        """libsvm's decision value ``K(x, SV) @ dual_coef + intercept``
        (float64, on the device)."""
        X = torch.as_tensor(np.asarray(X, dtype=np.float64),
                            device=self.device)
        if X.ndim != 2 or X.shape[1] != self.support_vectors_.shape[1]:
            raise ValueError(f"X has shape {tuple(X.shape)}; the model "
                             f"takes {self.support_vectors_.shape[1]} "
                             "features")
        K = rbf_kernel(X, self.support_vectors_, self.gamma_)
        return K @ self.dual_coef_ + self.intercept_

    def tensors(self):
        return [self.support_vectors_, self.dual_coef_]

    def _state(self) -> Dict:
        return {"kind": type(self).__name__, "C": self.C, "tol": self.tol,
                "gamma": self.gamma_, "intercept": self.intercept_,
                "support_vectors": self.support_vectors_.cpu().numpy(),
                "dual_coef": self.dual_coef_.cpu().numpy()}

    def _load(self, state: Dict) -> None:
        self.gamma_ = float(state["gamma"])
        self.intercept_ = float(state["intercept"])
        self.support_vectors_ = torch.as_tensor(
            np.asarray(state["support_vectors"], dtype=np.float64),
            device=self.device)
        self.dual_coef_ = torch.as_tensor(
            np.asarray(state["dual_coef"], dtype=np.float64),
            device=self.device)


class SVR(_SVM):
    """epsilon-SVR with the RBF kernel."""

    def __init__(self, C: float = 1.0, epsilon: float = 0.1,
                 tol: float = 1e-3, device="cuda"):
        super().__init__(C, tol, device)
        self.epsilon = float(epsilon)

    def fit(self, X, y) -> "SVR":
        y = np.asarray(y, dtype=np.float64)
        if y.ndim != 1:
            raise ValueError(f"y should be a 1d array, got an array of shape "
                             f"{y.shape} instead.")
        t0 = time.perf_counter()
        Xt = self._prepare(X)
        n = len(y)
        yt = torch.as_tensor(y, device=self.device)
        one = torch.ones(n, dtype=torch.float64, device=self.device)
        idx = torch.arange(n, device=self.device)
        sol = solve(self._kernel_q(Xt), torch.cat([idx, idx])[None],
                    torch.cat([one, -one])[None],
                    torch.cat([self.epsilon - yt, self.epsilon + yt])[None],
                    torch.full((1, 2 * n), self.C, dtype=torch.float64,
                               device=self.device),
                    torch.ones((1, 2 * n), dtype=torch.bool,
                               device=self.device), self.tol)
        self._keep_support(Xt, sol.alpha[0, :n] - sol.alpha[0, n:],
                           sol.rho[0])
        self.n_iter_ = int(sol.n_iter[0])
        _sync(self.device)
        self.smo_seconds_ = time.perf_counter() - t0
        return self

    def predict(self, X) -> np.ndarray:
        return self.decision_values(X).cpu().numpy()

    def to_state(self) -> Dict:
        state = self._state()
        state["epsilon"] = self.epsilon
        return state

    @classmethod
    def from_state(cls, state: Dict, device) -> "SVR":
        model = cls(state["C"], state["epsilon"], state["tol"], device)
        model._load(state)
        return model


class SVC(_SVM):
    """Binary C-SVC with the RBF kernel and, with ``probability``, Platt's
    probabilities as libsvm computes them."""

    def __init__(self, C: float = 1.0, tol: float = 1e-3,
                 probability: bool = False, random_state: int = 0,
                 device="cuda"):
        super().__init__(C, tol, device)
        self.probability = probability
        self.random_state = random_state

    def fit(self, X, y) -> "SVC":
        y = np.asarray(y)
        if y.ndim != 1:
            raise ValueError(f"y should be a 1d array, got an array of shape "
                             f"{y.shape} instead.")
        self.classes_ = np.unique(y)
        if len(self.classes_) != 2:
            raise ValueError(f"the port's SVC is binary; y has "
                             f"{len(self.classes_)} classes")
        t0 = time.perf_counter()
        Xt = self._prepare(X)
        # libsvm's order: class 0's rows first, each class in data order
        order = np.argsort(y != self.classes_[0], kind="stable")
        yl = np.where(y[order] == self.classes_[0], 1.0, -1.0)
        Xo = Xt[torch.as_tensor(order, device=self.device)]
        Kq = self._kernel_q(Xo)
        self.platt_seconds_ = 0.0
        if self.probability:
            self.probA_, self.probB_, self.platt_n_iter_ = \
                self._platt(Xo, Kq, yl)
            _sync(self.device)
            self.platt_seconds_ = time.perf_counter() - t0
        t1 = time.perf_counter()
        l = len(yl)
        sol = self._solve(Kq, torch.arange(l, device=self.device)[None],
                          torch.as_tensor(yl, device=self.device)[None])
        coef = torch.zeros(len(y), dtype=torch.float64, device=self.device)
        coef[torch.as_tensor(order, device=self.device)] = \
            sol.alpha[0] * torch.as_tensor(yl, device=self.device)
        self._keep_support(Xt, coef, sol.rho[0])
        self.n_iter_ = int(sol.n_iter[0])
        _sync(self.device)
        self.smo_seconds_ = time.perf_counter() - t1
        return self

    def _solve(self, Kq, rows, y, valid=None) -> Solution:
        valid = torch.ones_like(rows, dtype=torch.bool) if valid is None \
            else valid
        return solve(Kq, rows, y, -torch.ones_like(y),
                     torch.full_like(y, self.C), valid, self.tol)

    def _platt(self, Xo: torch.Tensor, Kq: torch.Tensor, yl: np.ndarray):
        """libsvm's ``svm_binary_svc_probability``: (probA, probB, the
        largest iteration count of the five fold problems)."""
        l = len(yl)
        g = torch.Generator().manual_seed(int(self.random_state))
        perm = torch.randperm(l, generator=g).numpy()
        dec = np.zeros(l)
        problems, held = [], []
        for k in range(N_FOLDS):
            begin, end = k * l // N_FOLDS, (k + 1) * l // N_FOLDS
            train = np.concatenate([perm[:begin], perm[end:]])
            n_pos = int((yl[train] > 0).sum())
            if n_pos == 0 or n_pos == len(train):
                # libsvm: +1 when only positives remain, -1 for negatives,
                # 0 when nothing remains
                dec[perm[begin:end]] = 0.0 if len(train) == 0 else \
                    (1.0 if n_pos else -1.0)
            else:
                problems.append(train)
                held.append(perm[begin:end])
        n_iter = 0
        if problems:
            L = max(len(t) for t in problems)
            rows = np.zeros((len(problems), L), dtype=np.int64)
            valid = np.zeros((len(problems), L), dtype=bool)
            for b, t in enumerate(problems):
                rows[b, :len(t)] = t
                valid[b, :len(t)] = True
            dev = self.device
            rows_t = torch.as_tensor(rows, device=dev)
            y_t = torch.as_tensor(np.where(valid, yl[rows], 1.0), device=dev)
            sol = self._solve(Kq, rows_t, y_t,
                              torch.as_tensor(valid, device=dev))
            n_iter = int(sol.n_iter.max())
            coef = sol.alpha * y_t
            for b, (t, h) in enumerate(zip(problems, held)):
                # the fold model's decision value on its held-out rows
                Kh = rbf_kernel(Xo[torch.as_tensor(h, device=dev)],
                                Xo[torch.as_tensor(t, device=dev)],
                                self.gamma_)
                dec[h] = (Kh @ coef[b, :len(t)] - sol.rho[b]).cpu().numpy()
        A, B = sigmoid_train(dec, yl)
        return A, B, n_iter

    def decision_function(self, X) -> np.ndarray:
        """sklearn's binary ``decision_function``: positive leans to
        ``classes_[1]``."""
        return -self.decision_values(X).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        # libsvm: class 0 when its decision value is > 0
        return np.where(self.decision_values(X).cpu().numpy() > 0,
                        self.classes_[0], self.classes_[1])

    def predict_proba(self, X) -> np.ndarray:
        if not self.probability:
            raise AttributeError("predict_proba needs probability=True")
        r01 = pairwise_probability(self.decision_values(X), self.probA_,
                                   self.probB_)
        return couple_two(r01).cpu().numpy()

    def to_state(self) -> Dict:
        state = self._state()
        state.update(probability=self.probability,
                     random_state=self.random_state,
                     classes=np.asarray(self.classes_))
        if self.probability:
            state.update(probA=self.probA_, probB=self.probB_)
        return state

    @classmethod
    def from_state(cls, state: Dict, device) -> "SVC":
        model = cls(state["C"], state["tol"], bool(state["probability"]),
                    state["random_state"], device)
        model._load(state)
        model.classes_ = np.asarray(state["classes"])
        if model.probability:
            model.probA_ = float(state["probA"])
            model.probB_ = float(state["probB"])
        return model


def sigmoid_train(dec: np.ndarray, labels: np.ndarray):
    """libsvm's ``sigmoid_train``: Platt's (A, B) by Newton's method with
    backtracking, on the host (one float a training row)."""
    dec = np.asarray(dec, dtype=np.float64)
    prior1 = float((labels > 0).sum())
    prior0 = float(len(labels) - prior1)
    max_iter, min_step, sigma, eps = 100, 1e-10, 1e-12, 1e-5
    hi, lo = (prior1 + 1.0) / (prior1 + 2.0), 1 / (prior0 + 2.0)
    t = np.where(labels > 0, hi, lo)

    def objective(A, B):
        f = dec * A + B
        log_term = np.log(1 + np.exp(-np.abs(f)))
        return np.where(f >= 0, t * f, (t - 1) * f).sum() + log_term.sum()

    A, B = 0.0, float(np.log((prior0 + 1.0) / (prior1 + 1.0)))
    fval = objective(A, B)
    for _ in range(max_iter):
        f = dec * A + B
        e = np.exp(-np.abs(f))
        p = np.where(f >= 0, e / (1.0 + e), 1.0 / (1.0 + e))
        q = np.where(f >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
        d2 = p * q
        h11 = sigma + (dec * dec * d2).sum()
        h22 = sigma + d2.sum()
        h21 = (dec * d2).sum()
        d1 = t - p
        g1 = (dec * d1).sum()
        g2 = d1.sum()
        if abs(g1) < eps and abs(g2) < eps:
            break
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= min_step:
            newA, newB = A + step * dA, B + step * dB
            newf = objective(newA, newB)
            if newf < fval + 0.0001 * step * gd:
                A, B, fval = newA, newB, newf
                break
            step /= 2.0
        if step < min_step:
            break
    return float(A), float(B)


def pairwise_probability(dec: torch.Tensor, A: float, B: float
                         ) -> torch.Tensor:
    """libsvm's ``sigmoid_predict`` in its stable form, clamped to
    ``[MIN_PROB, 1 - MIN_PROB]``: the probability of class 0 against
    class 1."""
    f = dec * A + B
    e = torch.exp(-f.abs())
    p = torch.where(f >= 0, e / (1.0 + e), 1.0 / (1.0 + e))
    return p.clamp(MIN_PROB, 1 - MIN_PROB)


def couple_two(r01: torch.Tensor) -> torch.Tensor:
    """libsvm's ``multiclass_probability`` for two classes, elementwise:
    p starts at 1/2; at most 100 sweeps of its Gauss-Seidel update, each
    row stopping once ``max |Qp - pQp| < 0.005 / 2``. Returns (M, 2)."""
    k = 2
    eps = 0.005 / k
    r10 = 1 - r01
    Q = [[r10 * r10, -r10 * r01], [-r10 * r01, r01 * r01]]
    p = [torch.full_like(r01, 1.0 / k), torch.full_like(r01, 1.0 / k)]
    active = torch.ones_like(r01, dtype=torch.bool)
    for _ in range(max(100, k)):
        Qp = [Q[t][0] * p[0] + Q[t][1] * p[1] for t in range(k)]
        pQp = p[0] * Qp[0] + p[1] * Qp[1]
        err = torch.maximum((Qp[0] - pQp).abs(), (Qp[1] - pQp).abs())
        active = active & ~(err < eps)
        if not bool(active.any()):
            break
        for t in range(k):
            diff = (-Qp[t] + pQp) / Q[t][t]
            p_t = p[t] + diff
            pQp_new = (pQp + diff * (diff * Q[t][t] + 2 * Qp[t])) \
                / (1 + diff) / (1 + diff)
            Qp_new = [(Qp[j] + diff * Q[t][j]) / (1 + diff) for j in range(k)]
            p_new = [(p_t if j == t else p[j]) / (1 + diff) for j in range(k)]
            p = [torch.where(active, p_new[j], p[j]) for j in range(k)]
            Qp = [torch.where(active, Qp_new[j], Qp[j]) for j in range(k)]
            pQp = torch.where(active, pQp_new, pQp)
    return torch.stack(p, 1)
