"""Minimal gradient-boosted tree trainer for the v6 meta-fusion.

A copy of tpudf/train/gbdt.py (numpy only), kept here so that this
package imports nothing of `tpudf`.

The reference optionally trains an XGBoost booster over the 19-d fusion
feature vector and Platt-scales its margin (appv3.py:1427-1477, 5507-5578).
XGBoost is a C++ dependency; this is a small dependency-free histogram GBDT
(logistic loss, depth-limited greedy trees) whose output plugs straight into
tpudf_torch.models.fusion.TreeEnsemble for batched on-device evaluation.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


def _fit_tree(X, grad, hess, depth, n_bins, lam, min_child):
    nodes = [_Node()]
    stack = [(0, np.arange(len(X)), 0)]
    while stack:
        nid, idx, d = stack.pop()
        g, h = grad[idx].sum(), hess[idx].sum()
        nodes[nid].value = -g / (h + lam)
        if d >= depth or len(idx) < 2 * min_child:
            continue
        best = None
        parent_score = g * g / (h + lam)
        gi, hi = grad[idx], hess[idx]
        for f in range(X.shape[1]):
            xs = X[idx, f]
            qs = np.unique(np.quantile(xs, np.linspace(0.05, 0.95, n_bins)))
            # vectorized split scan: (n_idx, n_thresh) mask → per-threshold
            # left sums as two matvecs instead of a python threshold loop
            lm = xs[:, None] < qs[None, :]
            nl = lm.sum(0)
            ok = (nl >= min_child) & (len(idx) - nl >= min_child)
            if not ok.any():
                continue
            gl = gi @ lm
            hl = hi @ lm
            gr, hr = g - gl, h - hl
            gain = np.where(ok, gl * gl / (hl + lam) + gr * gr / (hr + lam)
                            - parent_score, -np.inf)
            j = int(np.argmax(gain))
            if best is None or gain[j] > best[0]:
                best = (gain[j], f, qs[j], lm[:, j])
        if best is None or best[0] <= 1e-6:
            continue
        _, f, t, m = best
        li, ri = len(nodes), len(nodes) + 1
        nodes.append(_Node())
        nodes.append(_Node())
        nodes[nid].feature = f
        nodes[nid].threshold = float(t)
        nodes[nid].left = li
        nodes[nid].right = ri
        stack.append((li, idx[m], d + 1))
        stack.append((ri, idx[~m], d + 1))
    return nodes


def _tree_depth(nodes):
    """Actual max depth (an unbalanced depth-d chain has only 2d+1 nodes, so
    inferring steps from the node count under-walks it)."""
    maxd, stack = 0, [(0, 0)]
    while stack:
        nid, d = stack.pop()
        maxd = max(maxd, d)
        if nodes[nid].feature >= 0:
            stack.append((nodes[nid].left, d + 1))
            stack.append((nodes[nid].right, d + 1))
    return maxd


def _predict_tree(nodes, X):
    """Vectorized descent: all samples walk the tree together (leaves
    self-loop, so `depth` gather steps suffice) — no per-sample host loop."""
    feat = np.array([n.feature for n in nodes])
    thr = np.array([n.threshold for n in nodes])
    left = np.array([n.left if n.feature >= 0 else i
                     for i, n in enumerate(nodes)])
    right = np.array([n.right if n.feature >= 0 else i
                      for i, n in enumerate(nodes)])
    val = np.array([n.value for n in nodes])
    n = np.zeros(len(X), np.int64)
    depth = max(1, _tree_depth(nodes))
    safe_feat = np.maximum(feat, 0)
    for _ in range(depth):
        go_left = X[np.arange(len(X)), safe_feat[n]] < thr[n]
        n = np.where(feat[n] >= 0, np.where(go_left, left[n], right[n]), n)
    return val[n]


def train_gbdt(X, y, *, n_trees=50, depth=3, lr=0.2, n_bins=16, lam=1.0,
               min_child=5, seed=0):
    """Returns a list of node-lists + base margin; logistic objective."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    p0 = np.clip(y.mean(), 1e-3, 1 - 1e-3)
    base = float(np.log(p0 / (1 - p0)))
    margin = np.full(len(y), base)
    trees = []
    for _ in range(n_trees):
        p = 1 / (1 + np.exp(-margin))
        grad = p - y
        hess = p * (1 - p)
        nodes = _fit_tree(X, grad, hess, depth, n_bins, lam, min_child)
        for n in nodes:
            n.value *= lr
        margin += _predict_tree(nodes, X)
        trees.append(nodes)
    return {"trees": trees, "base": base}


def predict_margin(model, X):
    X = np.asarray(X, np.float64)
    m = np.full(len(X), model["base"])
    for nodes in model["trees"]:
        m += _predict_tree(nodes, X)
    return m


def fit_platt(margins, labels):
    """Logistic a·z+b calibration of GBDT margins (appv3.py:5568-5570)."""
    z = np.asarray(margins, np.float64)
    y = np.asarray(labels, np.float64)
    a, b = 1.0, 0.0
    for _ in range(200):
        p = 1 / (1 + np.exp(-(a * z + b)))
        ga = np.mean((p - y) * z)
        gb = np.mean(p - y)
        a -= 0.5 * ga
        b -= 0.5 * gb
    return float(a), float(b)


def to_tree_ensemble(model, platt_a=1.0, platt_b=0.0):
    """Convert to the device-evaluable TreeEnsemble
    (tpudf_torch.models.fusion.TreeEnsemble)."""
    from tpudf_torch.models.fusion import TreeEnsemble
    n = len(model["trees"])
    maxn = max(len(t) for t in model["trees"])
    feats = np.zeros((n, maxn), np.int32)
    thresh = np.full((n, maxn), -np.inf, np.float32)
    left = np.zeros((n, maxn), np.int32)
    right = np.zeros((n, maxn), np.int32)
    leaf = np.zeros((n, maxn), np.float32)
    for i, nodes in enumerate(model["trees"]):
        for j, nd in enumerate(nodes):
            if nd.feature >= 0:
                feats[i, j] = nd.feature
                thresh[i, j] = nd.threshold
                left[i, j] = nd.left
                right[i, j] = nd.right
            else:
                left[i, j] = j
                right[i, j] = j
                leaf[i, j] = nd.value
    return TreeEnsemble(feats, thresh, left, right, leaf, model["base"],
                        platt_a, platt_b)
