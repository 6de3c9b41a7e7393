"""CART trees on binary features, grown level by level over all trees of a
forest at once, on the tensors' device.

The counterpart of the trees inside the JAX package's
``RandomForestRegressor`` / ``RandomForestClassifier``
(polymer_chemprop_tpu/sklearn_train.py:83-97): sklearn's
``DepthFirstTreeBuilder`` with the ``BestSplitter``, criterion
``squared_error`` or ``gini``, ``min_samples_split=2``,
``min_samples_leaf=1``, no depth limit.

Morgan bits are 0 or 1, so every feature has one candidate split, at
threshold 0.5 (sklearn's midpoint of the two values): a row goes left when
its bit is 0. A node's statistics for the "bit = 1" child of every feature
are sums over the node's rows that have the bit; the "bit = 0" child is the
node's total less those. So a level costs one pass over the (row, set bit)
pairs of its in-bag rows, about 22 a molecule at radius 2 and 2,048 bits,
and never touches the zeros of the (rows x 2,048) matrix. The sums are
float64, as sklearn's.

Stop rules (sklearn's ``_tree.pyx``): a node is a leaf when it holds fewer
than two rows, when its impurity is at most ``EPS``, when every feature is
constant in it, when none of the features it drew is non-constant, or when
the best improvement plus ``EPS`` is below 0. Rows of weight 0 (out of
bag) are not in the tree at all, as sklearn's ``Splitter.init`` drops them;
``n_node_samples`` counts the distinct in-bag rows.

Two choices keep a tree the same on every device:

* the impurity that the ``EPS`` rule reads is centred (``Σ w (y - ȳ)²``
  for squared error), and a gini node is pure when one class alone has
  rows in it, counted exactly; so a node whose targets are all equal is a
  leaf whatever order the sums took. (sklearn subtracts ``(Σ w y)² / W``
  from ``Σ w y²``, whose rounding splits some such nodes.)
* ties: candidates within ``TIE_RTOL`` of a node's best proxy are tied,
  and the one drawn first (the lowest key) wins. Two features whose
  columns are equal inside a node give the same partition, and their
  proxies, summed in another order, may differ in the last bit.

``max_features`` is sklearn's: features are visited in a uniform random
order, constant ones counting against ``max_features``, and the search
stops after ``max_features`` visits once one non-constant feature has been
evaluated, else at the first non-constant one. Each (node, feature) has a
random key, a counter-based hash of the tree's seed, the node's id in its
tree and the feature (``feature_keys``): the candidates are the
non-constant features whose key is among the node's ``max_features``
smallest of all ``F`` keys, or, when none is, the non-constant feature of
smallest key. Integer arithmetic, so the keys are the same on every
device.

Prediction (``apply``) walks every (tree, row) pair down by gathers, one
level a step, to the deepest leaf; it takes any thresholds, so it also
serves trees read from sklearn's pickles (baselines/pickles.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

EPS = float(np.finfo(np.float64).eps)  # sklearn's EPSILON
THRESHOLD = 0.5                        # the split of a binary feature
LEAF = -1                              # children of a leaf (TREE_LEAF)
UNDEFINED = -2                         # feature of a leaf (TREE_UNDEFINED)
TIE_RTOL = 1e-12
_M32 = 0xFFFFFFFF
_KEY_CHUNK = 1 << 23                   # (node, feature) keys hashed at once
_APPLY_CHUNK = 1 << 22                 # (tree, row) pairs walked at once
_INT64_MAX = torch.iinfo(torch.int64).max

FOREST_FIELDS = ("offsets", "left", "right", "feature", "threshold",
                 "value", "n_node_samples", "weighted_n_node_samples",
                 "impurity")


@dataclasses.dataclass
class Forest:
    """Trees as flat arrays. Tree t's nodes are rows ``offsets[t]`` to
    ``offsets[t + 1]``, its root first; ``left`` and ``right`` hold flat
    row ids (``LEAF`` at leaves), ``feature`` is ``UNDEFINED`` at leaves.
    ``value`` is ``(nodes, outputs, classes)``: the weighted mean of each
    output (one class) or each output's weighted class fractions."""

    offsets: torch.Tensor                  # (T + 1,) int64
    left: torch.Tensor                     # (N,) int64
    right: torch.Tensor                    # (N,) int64
    feature: torch.Tensor                  # (N,) int64
    threshold: torch.Tensor                # (N,) float64
    value: torch.Tensor                    # (N, K, C) float64
    n_node_samples: torch.Tensor           # (N,) int64
    weighted_n_node_samples: torch.Tensor  # (N,) float64
    impurity: torch.Tensor                 # (N,) float64
    max_depth: int

    @property
    def n_trees(self) -> int:
        return self.offsets.numel() - 1

    def to_state(self) -> Dict:
        """Plain numpy arrays (the port's model.pkl)."""
        state = {f: getattr(self, f).cpu().numpy() for f in FOREST_FIELDS}
        state["max_depth"] = int(self.max_depth)
        return state

    @classmethod
    def from_state(cls, state: Dict, device) -> "Forest":
        return cls(**{f: torch.as_tensor(np.asarray(state[f]), device=device)
                      for f in FOREST_FIELDS},
                   max_depth=int(state["max_depth"]))


# ---------------------------------------------------------------------------
# Random keys
# ---------------------------------------------------------------------------

def _mulmod32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``x`` in [0, 2**32) in int64 without
    overflow: the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (Wellons' lowbias32) on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def feature_keys(seed: torch.Tensor, node: torch.Tensor, feat: torch.Tensor,
                 n_features: int) -> torch.Tensor:
    """The random key of feature ``feat`` at node ``node`` (the node's id in
    its tree) of the tree whose seed is ``seed`` (each in [0, 2**32)).
    Keys of one node are distinct (``hash * F + feat``); a smaller key is
    drawn earlier."""
    h = _mix32((seed + _mulmod32(node, 0x9E3779B9)) & _M32)
    h = _mix32((h + _mulmod32(feat, 0x85EBCA6B)) & _M32)
    return h * n_features + feat


def _kth_keys(seed: torch.Tensor, node: torch.Tensor, n_features: int,
              k: int) -> torch.Tensor:
    """For each (seed, node), the k-th smallest of its F feature keys."""
    out = torch.empty(node.numel(), dtype=torch.int64, device=node.device)
    feats = torch.arange(n_features, device=node.device)
    step = max(1, _KEY_CHUNK // n_features)
    for s in range(0, node.numel(), step):
        keys = feature_keys(seed[s:s + step, None], node[s:s + step, None],
                            feats[None], n_features)
        out[s:s + step] = torch.topk(keys, k, dim=1, largest=False).values[:, -1]
    return out


def sampled_candidates(key: torch.Tensor, cand_node: torch.Tensor,
                       kth_key: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Which non-constant candidates a node evaluates under sklearn's
    ``max_features`` rule.

    ``key`` is each candidate's key, ``cand_node`` its node, ``kth_key`` each
    node's ``max_features``-th smallest key over all its features. A
    candidate ranked below ``max_features`` is evaluated; when a node has
    none, its first non-constant feature (smallest key) is."""
    first = torch.full((n_nodes,), _INT64_MAX, dtype=torch.int64,
                       device=key.device)
    first.scatter_reduce_(0, cand_node, key, "amin")
    return (key <= kth_key[cand_node]) | (key == first[cand_node])


# ---------------------------------------------------------------------------
# Growing
# ---------------------------------------------------------------------------

def _node_stats(node_of, w, Y_rows, n_nodes, criterion, n_outputs):
    """W, S, the value, the impurity and the row count of each node."""
    dev = w.device
    W = torch.zeros(n_nodes, dtype=torch.float64, device=dev)
    W.index_add_(0, node_of, w)
    wY = w[:, None] * Y_rows
    S = torch.zeros((n_nodes, Y_rows.shape[1]), dtype=torch.float64,
                    device=dev)
    S.index_add_(0, node_of, wY)
    cnt = torch.bincount(node_of, minlength=n_nodes)
    value = S / W[:, None]
    if criterion == "mse":
        dev2 = Y_rows - value[node_of]
        sq = torch.zeros(n_nodes, dtype=torch.float64, device=dev)
        sq.index_add_(0, node_of, w * (dev2 * dev2).sum(1))
        impurity = sq / W / n_outputs
    else:
        frac = value.view(n_nodes, n_outputs, -1)
        impurity = (1.0 - (frac * frac).sum(2)).sum(1) / n_outputs
        present = torch.zeros_like(S).index_add_(0, node_of, Y_rows)
        pure = ((present.view(n_nodes, n_outputs, -1) > 0).sum(2) <= 1).all(1)
        impurity = torch.where(pure, torch.zeros_like(impurity), impurity)
    return W, S, wY, value, impurity, cnt


def _best_splits(bits_idx, bits_ptr, deg, node_of, row_of, w, wY, W, S, cnt,
                 splittable, f_seed, f_local, w_root, n_outputs, n_features,
                 max_features):
    """The chosen feature of each node (-1: none)."""
    dev = w.device
    n_nodes = W.numel()
    split_feat = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    sel = splittable[node_of]
    p_node, p_row = node_of[sel], row_of[sel]
    p_w, p_wY = w[sel], wY[sel]
    d = deg[p_row]
    n_entries = int(d.sum())
    if n_entries == 0:
        return split_feat
    # one entry for each (in-bag row, set bit) pair of a splittable node
    rep = torch.repeat_interleave(torch.arange(p_row.numel(), device=dev), d,
                                  output_size=n_entries)
    start = torch.cumsum(d, 0) - d
    within = torch.arange(n_entries, device=dev) - start[rep]
    feat = bits_idx[bits_ptr[p_row][rep] + within]
    uniq, inv = torch.unique(p_node[rep] * n_features + feat,
                             return_inverse=True)
    W1 = torch.zeros(uniq.numel(), dtype=torch.float64, device=dev)
    W1.index_add_(0, inv, p_w[rep])
    S1 = torch.zeros((uniq.numel(), S.shape[1]), dtype=torch.float64,
                     device=dev)
    S1.index_add_(0, inv, p_wY[rep])
    c1 = torch.bincount(inv, minlength=uniq.numel())
    c_node, c_feat = uniq // n_features, uniq % n_features
    nonconst = c1 < cnt[c_node]
    c_node, c_feat = c_node[nonconst], c_feat[nonconst]
    W1, S1 = W1[nonconst], S1[nonconst]
    if c_node.numel() == 0:
        return split_feat
    # sklearn's proxy improvement: Σ S_L² / W_L + S_R² / W_R
    WL = W[c_node] - W1
    SL = S[c_node] - S1
    proxy = (SL * SL / WL[:, None] + S1 * S1 / W1[:, None]).sum(1)
    key = feature_keys(f_seed[c_node], f_local[c_node], c_feat, n_features)
    if max_features < n_features:
        nodes = torch.unique(c_node)
        kth = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
        kth[nodes] = _kth_keys(f_seed[nodes], f_local[nodes], n_features,
                               max_features)
        ev = sampled_candidates(key, c_node, kth, n_nodes)
        c_node, c_feat, proxy, key = c_node[ev], c_feat[ev], proxy[ev], key[ev]
    best = torch.full((n_nodes,), -float("inf"), dtype=torch.float64,
                      device=dev)
    best.scatter_reduce_(0, c_node, proxy, "amax")
    tie = proxy >= best[c_node] - TIE_RTOL * best[c_node].abs()
    first = torch.full((n_nodes,), _INT64_MAX, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, c_node[tie], key[tie], "amin")
    pick = tie & (key == first[c_node])
    b_node, b_feat, b_proxy = c_node[pick], c_feat[pick], proxy[pick]
    # sklearn's improvement, (W imp - W_L imp_L - W_R imp_R) / W_root, and
    # its rule: a leaf when improvement + EPS < min_impurity_decrease (0)
    parent = (S[b_node] * S[b_node]).sum(1) / W[b_node]
    improvement = (b_proxy - parent) / n_outputs / w_root[b_node]
    ok = improvement + EPS >= 0
    split_feat[b_node[ok]] = b_feat[ok]
    return split_feat


def grow_forest(bits: torch.Tensor, Y: torch.Tensor, weights: torch.Tensor,
                seeds: torch.Tensor, criterion: str, n_outputs: int,
                max_features: Optional[int] = None) -> Forest:
    """Grow ``T`` trees at once.

    bits:     (n, F) uint8 0/1 features
    Y:        (n, D) float64 targets (``mse``: D = outputs) or one-hot
              classes (``gini``: D = outputs x classes)
    weights:  (T, n) float64 sample weights of each tree (bootstrap counts
              times class weights); rows of weight 0 are out of the tree
    seeds:    (T,) int64 in [0, 2**32): each tree's feature-key seed
    max_features: features a node draws (None: all)
    """
    if criterion not in ("mse", "gini"):
        raise ValueError(f"criterion {criterion!r}: 'mse' or 'gini'")
    dev = bits.device
    n, F = bits.shape
    T = weights.shape[0]
    max_features = F if max_features is None else int(max_features)
    if not 1 <= max_features <= F:
        raise ValueError(f"max_features {max_features} outside [1, {F}]")
    rows_nz, bits_idx = bits.nonzero(as_tuple=True)
    deg = torch.bincount(rows_nz, minlength=n)
    bits_ptr = torch.cumsum(deg, 0) - deg
    tree_of, row_of = (weights > 0).nonzero(as_tuple=True)
    w = weights[tree_of, row_of]
    w_root_tree = weights.sum(1)

    # the frontier: one entry a node of this level, in (tree, id) order
    f_tree = torch.arange(T, device=dev)
    f_local = torch.zeros(T, dtype=torch.int64, device=dev)
    node_of = tree_of
    n_alloc = torch.ones(T, dtype=torch.int64, device=dev)
    levels = []
    while f_tree.numel():
        N = f_tree.numel()
        W, S, wY, value, impurity, cnt = _node_stats(
            node_of, w, Y[row_of], N, criterion, n_outputs)
        splittable = (cnt >= 2) & (impurity > EPS)
        split_feat = _best_splits(
            bits_idx, bits_ptr, deg, node_of, row_of, w, wY, W, S, cnt,
            splittable, seeds[f_tree], f_local, w_root_tree[f_tree],
            n_outputs, F, max_features)
        is_split = split_feat >= 0
        ns = is_split.long()
        per_tree = torch.zeros(T, dtype=torch.int64, device=dev)
        per_tree.index_add_(0, f_tree, ns)
        before = torch.cumsum(ns, 0) - ns          # splits before, all trees
        in_tree = before - (torch.cumsum(per_tree, 0) - per_tree)[f_tree]
        left_local = n_alloc[f_tree] + 2 * in_tree
        n_alloc = n_alloc + 2 * per_tree
        levels.append((f_tree, f_local, split_feat,
                       torch.where(is_split, left_local, LEAF), cnt, W,
                       impurity, value))
        # the next level: both children of each split node; rows follow
        # their bit of the split feature (0: left)
        sidx = is_split.nonzero().squeeze(1)
        f_tree = f_tree[sidx].repeat_interleave(2)
        f_local = torch.stack([left_local[sidx], left_local[sidx] + 1],
                              1).reshape(-1)
        keep = is_split[node_of]
        node_of, row_of, w = node_of[keep], row_of[keep], w[keep]
        bit = bits[row_of, split_feat[node_of]].long()
        node_of = 2 * before[node_of] + bit

    offsets = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(n_alloc, 0)
    N = int(offsets[-1])
    D = Y.shape[1]
    out = {
        "left": torch.full((N,), LEAF, dtype=torch.int64, device=dev),
        "right": torch.full((N,), LEAF, dtype=torch.int64, device=dev),
        "feature": torch.full((N,), UNDEFINED, dtype=torch.int64, device=dev),
        "threshold": torch.full((N,), float(UNDEFINED), dtype=torch.float64,
                                device=dev),
        "value": torch.zeros((N, D), dtype=torch.float64, device=dev),
        "n_node_samples": torch.zeros(N, dtype=torch.int64, device=dev),
        "weighted_n_node_samples": torch.zeros(N, dtype=torch.float64,
                                               device=dev),
        "impurity": torch.zeros(N, dtype=torch.float64, device=dev),
    }
    for tree, local, feat, left, cnt, W, impurity, value in levels:
        g = offsets[tree] + local
        split = feat >= 0
        gl = offsets[tree] + left
        out["left"][g] = torch.where(split, gl, LEAF)
        out["right"][g] = torch.where(split, gl + 1, LEAF)
        out["feature"][g] = torch.where(split, feat, UNDEFINED)
        out["threshold"][g] = torch.where(
            split, torch.full_like(W, THRESHOLD),
            torch.full_like(W, float(UNDEFINED)))
        out["n_node_samples"][g] = cnt
        out["weighted_n_node_samples"][g] = W
        out["impurity"][g] = impurity
        out["value"][g] = value
    out["value"] = out["value"].view(N, n_outputs, D // n_outputs)
    return Forest(offsets=offsets, max_depth=len(levels) - 1, **out)


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------

def apply(forest: Forest, X: torch.Tensor) -> torch.Tensor:
    """(T, M) flat id of the leaf each row of ``X`` (M, F) reaches in each
    tree: a row goes left when ``X[row, feature] <= threshold``."""
    T, M = forest.n_trees, X.shape[0]
    dev = X.device
    leaves = torch.empty((T, M), dtype=torch.int64, device=dev)
    step = max(1, _APPLY_CHUNK // max(T, 1))
    for s in range(0, M, step):
        rows = torch.arange(s, min(M, s + step), device=dev)
        node = forest.offsets[:-1, None].expand(T, rows.numel()).clone()
        for _ in range(forest.max_depth):
            left = forest.left[node]
            go_left = X[rows[None], forest.feature[node].clamp(min=0)] \
                <= forest.threshold[node]
            nxt = torch.where(go_left, left, forest.right[node])
            node = torch.where(left >= 0, nxt, node)
        leaves[:, s:s + rows.numel()] = node
    return leaves


def leaf_values(forest: Forest, X: torch.Tensor) -> torch.Tensor:
    """(M, K, C) mean over the trees of the leaf values ``X`` reaches."""
    return forest.value[apply(forest, X)].mean(0)
