"""Learned index-parameter prediction (paper Eq. 4): a random-forest
regressor p̂ = f(x; θ) over workload features x = [μ_e, σ_e, ‖q‖, log N, p, …]
predicting the (n_probe, ef) that hits a recall target at minimum cost.

The port's own copy of the reference's ``repro.core.learned``: numpy CART
trees and bootstrap bagging seeded through ``np.random.default_rng``, so a
forest fit on the same data predicts the same bits as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class DecisionTreeRegressor:
    """CART with MSE splits, depth/min-samples bounded."""

    def __init__(self, max_depth: int = 6, min_samples_leaf: int = 4,
                 n_thresholds: int = 16):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.n_thresholds = n_thresholds
        self.nodes: List[_Node] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "DecisionTreeRegressor":
        self.nodes = []
        self._grow(np.asarray(X, np.float64), np.asarray(y, np.float64), 0)
        return self

    def _grow(self, X, y, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append(_Node(value=float(y.mean()) if len(y) else 0.0))
        if (depth >= self.max_depth or len(y) < 2 * self.min_samples_leaf
                or np.allclose(y, y[0])):
            return idx
        best = None  # (sse, feat, thr)
        for f in range(X.shape[1]):
            col = X[:, f]
            qs = np.unique(np.quantile(col, np.linspace(0.05, 0.95, self.n_thresholds)))
            for thr in qs:
                m = col <= thr
                nl, nr = int(m.sum()), int((~m).sum())
                if nl < self.min_samples_leaf or nr < self.min_samples_leaf:
                    continue
                yl, yr = y[m], y[~m]
                sse = (yl.var() * nl) + (yr.var() * nr)
                if best is None or sse < best[0]:
                    best = (sse, f, float(thr))
        if best is None:
            return idx
        _, f, thr = best
        m = X[:, f] <= thr
        node = self.nodes[idx]
        node.feature, node.threshold = f, thr
        node.left = self._grow(X[m], y[m], depth + 1)
        node.right = self._grow(X[~m], y[~m], depth + 1)
        return idx

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        out = np.empty(len(X))
        for i, row in enumerate(X):
            n = 0
            while self.nodes[n].feature >= 0:
                n = (self.nodes[n].left if row[self.nodes[n].feature]
                     <= self.nodes[n].threshold else self.nodes[n].right)
            out[i] = self.nodes[n].value
        return out


class RandomForestRegressor:
    def __init__(self, n_trees: int = 16, max_depth: int = 6,
                 min_samples_leaf: int = 4, seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.seed = seed
        self.trees: List[DecisionTreeRegressor] = []

    def fit(self, X, y) -> "RandomForestRegressor":
        rng = np.random.default_rng(self.seed)
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        self.trees = []
        for _ in range(self.n_trees):
            boot = rng.integers(0, len(X), len(X))
            t = DecisionTreeRegressor(self.max_depth, self.min_samples_leaf)
            t.fit(X[boot], y[boot])
            self.trees.append(t)
        return self

    def predict(self, X) -> np.ndarray:
        return np.mean([t.predict(X) for t in self.trees], axis=0)


@dataclasses.dataclass
class ParamPredictor:
    """Eq. 4 wrapper: features -> predicted (n_probe, ef)."""
    probe_model: Optional[RandomForestRegressor] = None
    ef_model: Optional[RandomForestRegressor] = None

    @staticmethod
    def featurize(queries: np.ndarray, n: int, n_partitions: int) -> np.ndarray:
        q = np.asarray(queries, np.float64)
        mu = q.mean(axis=1)
        sd = q.std(axis=1)
        nrm = np.linalg.norm(q, axis=1)
        return np.stack([mu, sd, nrm,
                         np.full(len(q), np.log(max(n, 2))),
                         np.full(len(q), float(n_partitions))], axis=1)

    def fit(self, feats: np.ndarray, best_probe: np.ndarray,
            best_ef: np.ndarray) -> "ParamPredictor":
        self.probe_model = RandomForestRegressor(seed=1).fit(feats, best_probe)
        self.ef_model = RandomForestRegressor(seed=2).fit(feats, best_ef)
        return self

    def predict(self, feats: np.ndarray):
        p = np.clip(np.round(self.probe_model.predict(feats)), 1, None).astype(int)
        e = np.clip(np.round(self.ef_model.predict(feats)), 8, None).astype(int)
        return p, e
