"""Isolation Forest: native implementation (host tree build, device scoring).

Reference: core isolationforest/IsolationForest.scala:18-62, which wraps the
external JVM library com.linkedin.isolation-forest (SURVEY §2.9 item 5 —
external engine the TPU build must re-implement, not wrap).

Counterpart of the JAX package's `isolationforest/iforest.py`, with its
Params, defaults and output columns.  iTrees are grown on the host from
small subsamples (cheap, O(T·s·log s)) by the reference's code, copied,
from the same `np.random.default_rng(seed)` stream, so the trees are the
JAX package's, and packed into dense (num_trees, max_nodes) arrays.
Scoring — the data-sized cost — runs on the card: a fixed-depth loop of
gathers that moves an [n, T] matrix of node ids down all trees at once
(leaves self-loop, so extra levels are no-ops), then the f32 mean over
the trees of `depth_at + adjust`.  Each stage has a `device` Param: the
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table, features_matrix
from ..device import DEVICE_DOC, resolve_device

__all__ = ["IsolationForest", "IsolationForestModel"]


def _c(n) -> float:
    """Average path length of an unsuccessful BST search: 2H(n-1) - 2(n-1)/n."""
    n = float(n)
    if n <= 1.0:
        return 0.0
    return 2.0 * (np.log(n - 1.0) + 0.5772156649) - 2.0 * (n - 1.0) / n


def _build_tree(x: np.ndarray, rng: np.random.Generator, max_depth: int,
                feature_idx: np.ndarray):
    """Grow one iTree; returns dict of dense node arrays."""
    max_nodes = 2 ** (max_depth + 1) - 1
    feature = np.zeros(max_nodes, np.int32)
    threshold = np.zeros(max_nodes, np.float32)
    left = np.arange(max_nodes, dtype=np.int32)   # leaves self-loop
    right = np.arange(max_nodes, dtype=np.int32)
    adjust = np.zeros(max_nodes, np.float32)      # c(|leaf|) path correction
    depth_at = np.zeros(max_nodes, np.float32)

    stack = [(0, x, 0)]  # (node id, rows, depth)
    while stack:
        node, rows, depth = stack.pop()
        depth_at[node] = depth
        n = len(rows)
        if depth >= max_depth or n <= 1:
            adjust[node] = _c(n)
            continue
        f = int(feature_idx[int(rng.integers(len(feature_idx)))])
        lo, hi = rows[:, f].min(), rows[:, f].max()
        if lo == hi:
            adjust[node] = _c(n)
            continue
        thr = float(rng.uniform(lo, hi))
        mask = rows[:, f] < thr
        feature[node] = f
        threshold[node] = thr
        lc, rc = 2 * node + 1, 2 * node + 2
        left[node], right[node] = lc, rc
        stack.append((lc, rows[mask], depth + 1))
        stack.append((rc, rows[~mask], depth + 1))
    return feature, threshold, left, right, adjust, depth_at


_ROWS = 1 << 18  # rows scored a chunk: [rows, T] node ids and features


def _path_lengths(x, feature, threshold, left, right, adjust, depth_at,
                  max_depth: int):
    """Average path length per row over all trees.

    x: (n, d); tree arrays: (T, max_nodes), all tensors on one device.
    Fixed-depth traversal of an [n, T] node matrix: leaves self-loop so
    extra iterations are no-ops.
    """
    n, t = x.shape[0], feature.shape[0]
    tree = torch.arange(t, device=x.device)[None, :]
    node = torch.zeros((n, t), dtype=torch.int64, device=x.device)
    for _ in range(max_depth):
        f = feature[tree, node]
        thr = threshold[tree, node]
        go_left = torch.gather(x, 1, f.long()) < thr
        node = torch.where(go_left, left[tree, node],
                           right[tree, node]).long()
    h = depth_at[tree, node] + adjust[tree, node]
    return torch.mean(h, dim=1)


@register_stage
class IsolationForest(Estimator):
    """Parameter names follow the reference wrapper (IsolationForest.scala)."""

    features_col = Param("features column", default="features")
    prediction_col = Param("outlier label column (1 = outlier)",
                           default="predicted_label")
    score_col = Param("anomaly score column", default="outlier_score")
    num_estimators = Param("number of trees", default=100,
                           converter=TypeConverters.to_int)
    max_samples = Param("subsample size per tree", default=256,
                        converter=TypeConverters.to_int)
    max_features = Param("fraction of features per tree", default=1.0,
                         converter=TypeConverters.to_float)
    bootstrap = Param("sample with replacement", default=False,
                      converter=TypeConverters.to_bool)
    contamination = Param("expected outlier fraction (0 = score only)",
                          default=0.0, converter=TypeConverters.to_float)
    seed = Param("rng seed", default=0, converter=TypeConverters.to_int)
    device = Param(DEVICE_DOC, default=None)

    def _fit(self, table: Table) -> "IsolationForestModel":
        x = features_matrix(table[self.features_col])
        n, d = x.shape
        rng = np.random.default_rng(int(self.seed))
        s = min(int(self.max_samples), n)
        max_depth = max(int(np.ceil(np.log2(max(s, 2)))), 1)
        n_feat = max(int(np.ceil(float(self.max_features) * d)), 1)

        trees = []
        for _ in range(int(self.num_estimators)):
            idx = (
                rng.integers(0, n, size=s)
                if self.bootstrap
                else rng.choice(n, size=s, replace=False)
            )
            feats = rng.choice(d, size=n_feat, replace=False)
            trees.append(_build_tree(x[idx], rng, max_depth, feats))

        packed = tuple(np.stack(a) for a in zip(*trees))
        # contamination=0 is score-only mode: threshold above the score range
        # (scores are in (0, 1]) so no row is ever labeled an outlier —
        # matching the reference engine's behavior
        model = IsolationForestModel(
            trees=packed, max_depth=max_depth, subsample_size=s,
            features_col=self.features_col,
            prediction_col=self.prediction_col, score_col=self.score_col,
            threshold=2.0, device=self.device,
        )
        if float(self.contamination) > 0:
            scores = model._scores(x)
            model.set(threshold=float(
                np.quantile(scores, 1.0 - float(self.contamination))
            ))
        return model


@register_stage
class IsolationForestModel(Model):
    features_col = Param("features column", default="features")
    prediction_col = Param("outlier label column", default="predicted_label")
    score_col = Param("anomaly score column", default="outlier_score")
    max_depth = Param("tree depth limit", default=8,
                      converter=TypeConverters.to_int)
    subsample_size = Param("per-tree subsample size", default=256,
                           converter=TypeConverters.to_int)
    threshold = Param("outlier score threshold (2.0 = score-only, never "
                      "labels)", default=2.0, converter=TypeConverters.to_float)
    trees = ComplexParam("packed tree arrays")
    device = Param(DEVICE_DOC, default=None)

    def _scores(self, x: np.ndarray) -> np.ndarray:
        dev = resolve_device(self.device)
        trees = [torch.as_tensor(np.require(a, None, "W"), device=dev)
                 for a in self.trees]
        x = np.ascontiguousarray(x, np.float32)
        h = np.concatenate([
            _path_lengths(torch.as_tensor(x[lo: lo + _ROWS], device=dev),
                          *trees, max_depth=int(self.max_depth)).cpu().numpy()
            for lo in range(0, len(x), _ROWS)])
        cn = _c(int(self.subsample_size))
        return np.asarray(2.0 ** (-h / max(cn, 1e-9)), np.float64)

    def _transform(self, table: Table) -> Table:
        x = features_matrix(table[self.features_col])
        scores = (
            self._scores(x) if len(x) else np.zeros((0,), np.float64)
        )
        out = table.with_column(self.score_col, scores)
        return out.with_column(
            self.prediction_col,
            (scores >= float(self.threshold)).astype(np.int64),
        )
