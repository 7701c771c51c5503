"""Training objectives: gradients/hessians of loss wrt raw scores.

Mirrors the reference's objective surface (lightgbm/params/TrainParams.scala
objective strings; custom FObjTrait lightgbm/params/FObjParam.scala): binary,
multiclass, regression (l2/l1/huber/fair/poisson/quantile/mape/tweedie) and
lambdarank.  All are vectorized numpy (host; a copy of the JAX package's
`gbdt/objectives.py`); a custom objective is any callable
(scores, label, weight) -> (grad, hess) — the FObjTrait analog.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["get_objective", "Objective", "lambdarank_grad"]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softmax(x, axis=-1):
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


class Objective:
    """name, num_model_per_iteration, grad/hess, raw->prediction transform."""

    def __init__(self, name: str, grad_fn: Callable, transform: Callable,
                 init_score_fn: Callable, num_class: int = 1):
        self.name = name
        self.grad_fn = grad_fn          # (scores, y, w) -> (grad, hess)
        self.transform = transform      # raw scores -> user-facing prediction
        self.init_score_fn = init_score_fn  # (y, w) -> scalar or [C]
        self.num_class = num_class


def _binary(sigmoid_scale: float = 1.0, pos_weight: float = 1.0):
    def grad_fn(scores, y, w):
        p = _sigmoid(sigmoid_scale * scores)
        wp = np.where(y > 0, pos_weight, 1.0) * w
        grad = sigmoid_scale * (p - y) * wp
        hess = sigmoid_scale**2 * p * (1 - p) * wp
        return grad, np.maximum(hess, 1e-16)

    def init(y, w):
        p = np.clip(np.average(y, weights=w), 1e-6, 1 - 1e-6)
        return float(np.log(p / (1 - p)) / sigmoid_scale)

    return Objective("binary", grad_fn, lambda s: _sigmoid(sigmoid_scale * s), init)


def _multiclass(num_class: int):
    def grad_fn(scores, y, w):  # scores [N, C]
        p = _softmax(scores)
        onehot = np.eye(num_class)[y.astype(np.int64)]
        grad = (p - onehot) * w[:, None]
        hess = 2.0 * p * (1 - p) * w[:, None]
        return grad, np.maximum(hess, 1e-16)

    def init(y, w):
        counts = np.bincount(y.astype(np.int64), weights=w, minlength=num_class)
        p = np.clip(counts / counts.sum(), 1e-6, 1.0)
        return np.log(p)

    return Objective("multiclass", grad_fn, lambda s: _softmax(s), init, num_class)


def _regression_l2():
    def grad_fn(scores, y, w):
        return (scores - y) * w, np.ones_like(scores) * w

    return Objective("regression", grad_fn, lambda s: s,
                     lambda y, w: float(np.average(y, weights=w)))


def _regression_l1():
    def grad_fn(scores, y, w):
        return np.sign(scores - y) * w, np.ones_like(scores) * w

    return Objective("regression_l1", grad_fn, lambda s: s,
                     lambda y, w: float(np.median(y)))


def _huber(alpha: float):
    def grad_fn(scores, y, w):
        d = scores - y
        grad = np.where(np.abs(d) <= alpha, d, alpha * np.sign(d)) * w
        return grad, np.ones_like(scores) * w

    return Objective("huber", grad_fn, lambda s: s,
                     lambda y, w: float(np.median(y)))


def _fair(c: float):
    def grad_fn(scores, y, w):
        d = scores - y
        grad = c * d / (np.abs(d) + c) * w
        hess = c * c / (np.abs(d) + c) ** 2 * w
        return grad, np.maximum(hess, 1e-16)

    return Objective("fair", grad_fn, lambda s: s,
                     lambda y, w: float(np.median(y)))


def _poisson():
    def grad_fn(scores, y, w):
        mu = np.exp(scores)
        return (mu - y) * w, np.maximum(mu * w, 1e-16)

    return Objective("poisson", grad_fn, lambda s: np.exp(s),
                     lambda y, w: float(np.log(max(np.average(y, weights=w), 1e-9))))


def _quantile(alpha: float):
    def grad_fn(scores, y, w):
        d = scores - y
        grad = np.where(d >= 0, 1.0 - alpha, -alpha) * w
        return grad, np.ones_like(scores) * w

    return Objective("quantile", grad_fn, lambda s: s,
                     lambda y, w: float(np.quantile(y, alpha)))


def _mape():
    def grad_fn(scores, y, w):
        denom = np.maximum(np.abs(y), 1.0)
        grad = np.sign(scores - y) / denom * w
        return grad, np.ones_like(scores) / denom * w

    return Objective("mape", grad_fn, lambda s: s,
                     lambda y, w: float(np.median(y)))


def _tweedie(rho: float):
    def grad_fn(scores, y, w):
        mu1 = np.exp((1 - rho) * scores)
        mu2 = np.exp((2 - rho) * scores)
        grad = (-y * mu1 + mu2) * w
        hess = (-y * (1 - rho) * mu1 + (2 - rho) * mu2) * w
        return grad, np.maximum(hess, 1e-16)

    return Objective("tweedie", grad_fn, lambda s: np.exp(s),
                     lambda y, w: float(np.log(max(np.average(y, weights=w), 1e-9))))


def lambdarank_grad(scores, y, w, group_ids, sigmoid: float = 1.0,
                    truncation: int = 30):
    """LambdaRank gradients with NDCG@truncation delta weighting.

    Reference objective `lambdarank` (TrainParams rankingObjectives;
    LightGBMRanker.scala).  Pairwise within each query group."""
    n = len(scores)
    grad = np.zeros(n)
    hess = np.full(n, 1e-16)
    for g in np.unique(group_ids):
        idx = np.where(group_ids == g)[0]
        if len(idx) < 2:
            continue
        s, rel = scores[idx], y[idx]
        order = np.argsort(-s)
        ranks = np.empty_like(order)
        ranks[order] = np.arange(len(idx))
        gains = (2.0**rel - 1.0)
        ideal = np.sort(gains)[::-1]
        disc = 1.0 / np.log2(np.arange(len(idx)) + 2.0)
        topk = min(truncation, len(idx))
        idcg = float((ideal[:topk] * disc[:topk]).sum())
        if idcg <= 0:
            continue
        for a in range(len(idx)):
            for b in range(len(idx)):
                if rel[a] <= rel[b]:
                    continue
                # |delta NDCG| of swapping ranks a,b
                da, db = disc[ranks[a]], disc[ranks[b]]
                delta = abs((gains[a] - gains[b]) * (da - db)) / idcg
                diff = sigmoid * (s[a] - s[b])
                rho = 1.0 / (1.0 + np.exp(diff))
                lam = sigmoid * delta * rho
                h = sigmoid**2 * delta * rho * (1 - rho)
                grad[idx[a]] -= lam
                grad[idx[b]] += lam
                hess[idx[a]] += h
                hess[idx[b]] += h
    return grad * w, hess * w


def get_objective(
    name: str,
    num_class: int = 1,
    alpha: float = 0.9,
    fair_c: float = 1.0,
    tweedie_variance_power: float = 1.5,
    sigmoid: float = 1.0,
    scale_pos_weight: float = 1.0,
) -> Objective:
    name = name.lower()
    if name in ("binary", "binary_logloss"):
        return _binary(sigmoid, scale_pos_weight)
    if name in ("multiclass", "softmax", "multiclassova"):
        if num_class < 2:
            raise ValueError("multiclass objective needs num_class >= 2")
        return _multiclass(num_class)
    if name in ("regression", "regression_l2", "l2", "mean_squared_error", "mse"):
        return _regression_l2()
    if name in ("regression_l1", "l1", "mae"):
        return _regression_l1()
    if name == "huber":
        return _huber(alpha)
    if name == "fair":
        return _fair(fair_c)
    if name == "poisson":
        return _poisson()
    if name == "quantile":
        return _quantile(alpha)
    if name == "mape":
        return _mape()
    if name == "tweedie":
        return _tweedie(tweedie_variance_power)
    raise ValueError(f"unknown objective '{name}'")
