"""Contextual bandit (CB/ADF) learner with IPS/SNIPS off-policy metrics.

Reference: vw/VowpalWabbitContextualBandit.scala:376 — multi-example
"shared + actions" ingestion, cost regression with inverse-propensity
weighting, ContextualBanditMetrics (ipsEstimate/snipsEstimate).

Row contract:
  shared_col : sparse (indices, values) shared-context features
  features_col : list of per-action sparse (indices, values) feature sets
  chosen_action_col : 1-based index of the logged action (VW convention)
  cost_col : observed cost of the chosen action (lower is better)
  probability_col : logging policy's probability of the chosen action

Training = IPS-weighted squared-loss regression on (shared + action)
features of the chosen action.

Counterpart of the JAX package's `online/contextual_bandit.py`, with its
Params, defaults, output columns and metrics.  Each pass is one launch of
kernel K1 (`ops/online_pass.py`) with the bandit's loss: the
importance weight scales the gradient and the loss, and l1 = l2 = 0.
The predicted costs are a gather and a row sum in PyTorch.  Each stage
has a `device` Param: the card unless the caller passes ``device="cpu"``,
where the pass is K1's plain loop.  Weights are numpy arrays, as in the
JAX package.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table
from ..device import DEVICE_DOC, resolve_device
from ..ops.online_pass import online_pass, plan_rows

__all__ = [
    "VowpalWabbitContextualBandit",
    "VowpalWabbitContextualBanditModel",
    "ContextualBanditMetrics",
]


def _merge_sparse(a: Tuple[np.ndarray, np.ndarray],
                  b: Tuple[np.ndarray, np.ndarray]):
    return (np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]]))


def _cb_scores(w: torch.Tensor, idx: torch.Tensor,
               val: torch.Tensor) -> torch.Tensor:
    """Predicted costs: (n, max_actions, A) gathers -> (n, max_actions)."""
    return torch.sum(w[idx] * val, dim=-1)


class ContextualBanditMetrics:
    """Streaming IPS / SNIPS estimators of the learned policy's reward.

    Reference: ContextualBanditMetrics in
    vw/VowpalWabbitContextualBandit.scala (snips/ips estimates).
    """

    def __init__(self):
        self.total_events = 0
        self.ips_numerator = 0.0
        self.snips_denominator = 0.0

    def add(self, match: bool, cost: float, prob: float):
        self.total_events += 1
        if match:
            self.ips_numerator += cost / max(prob, 1e-9)
            self.snips_denominator += 1.0 / max(prob, 1e-9)

    def ips_estimate(self) -> float:
        return self.ips_numerator / max(self.total_events, 1)

    def snips_estimate(self) -> float:
        return self.ips_numerator / max(self.snips_denominator, 1e-9)


def _pad_actions(shared_col, actions_col):
    """Merge shared features into every action's features; pad to
    (n, max_actions, A) index/value arrays + per-row action counts."""
    n = len(actions_col)
    merged: List[List[Tuple[np.ndarray, np.ndarray]]] = []
    for i in range(n):
        shared = shared_col[i] if shared_col is not None else (
            np.zeros(0, np.uint32), np.zeros(0, np.float32))
        merged.append([_merge_sparse(shared, a) for a in actions_col[i]])
    max_actions = max(len(m) for m in merged)
    max_active = max(
        (len(f[0]) for m in merged for f in m), default=1
    )
    max_active = max(max_active, 1)
    idx = np.zeros((n, max_actions, max_active), np.uint32)
    val = np.zeros((n, max_actions, max_active), np.float32)
    counts = np.zeros(n, np.int32)
    for i, m in enumerate(merged):
        counts[i] = len(m)
        for j, (ind, va) in enumerate(m):
            a = len(ind)
            idx[i, j, :a] = ind
            val[i, j, :a] = va
    return idx, val, counts


@register_stage
class VowpalWabbitContextualBandit(Estimator):
    """CB/ADF cost-regression learner (reference
    VowpalWabbitContextualBandit.scala)."""

    shared_col = Param("shared-context sparse features column", default="shared")
    features_col = Param("per-action sparse features list column",
                         default="features")
    chosen_action_col = Param("1-based logged action index column",
                              default="chosen_action")
    cost_col = Param("observed cost column (lower better)", default="cost")
    probability_col = Param("logging probability column", default="probability")
    prediction_col = Param("predicted-cost-per-action output column",
                           default="prediction")
    num_bits = Param("weight-table bits", default=18,
                     converter=TypeConverters.to_int)
    num_passes = Param("passes over the data", default=1,
                       converter=TypeConverters.to_int)
    learning_rate = Param("base learning rate", default=0.5,
                          converter=TypeConverters.to_float)
    clip_weight = Param("max inverse-propensity weight", default=100.0,
                        converter=TypeConverters.to_float)
    device = Param(DEVICE_DOC, default=None)

    def _fit(self, table: Table) -> "VowpalWabbitContextualBanditModel":
        shared = table[self.shared_col] if self.shared_col in table else None
        actions = table[self.features_col]
        chosen = np.asarray(table[self.chosen_action_col], np.int64) - 1
        cost = np.asarray(table[self.cost_col], np.float32)
        prob = np.asarray(table[self.probability_col], np.float32)

        meta = table.get_meta(self.features_col)
        bits = int(meta.get("num_bits", self.num_bits))
        dim = 1 << bits

        n = len(table)
        # chosen-action training examples
        ex_idx, ex_val = [], []
        for i in range(n):
            sh = shared[i] if shared is not None else (
                np.zeros(0, np.uint32), np.zeros(0, np.float32))
            ind, va = _merge_sparse(sh, actions[i][int(chosen[i])])
            ex_idx.append(ind)
            ex_val.append(va)
        max_active = max(max((len(x) for x in ex_idx), default=1), 1)
        idx = np.zeros((n, max_active), np.uint32)
        val = np.zeros((n, max_active), np.float32)
        for i in range(n):
            a = len(ex_idx[i])
            idx[i, :a] = ex_idx[i]
            val[i, :a] = ex_val[i]
        iw = np.minimum(1.0 / np.maximum(prob, 1e-9),
                        float(self.clip_weight)).astype(np.float32)

        dev = resolve_device(self.device)
        w = torch.zeros(dim, dtype=torch.float32, device=dev)
        g2 = torch.zeros(dim, dtype=torch.float32, device=dev)
        plan = plan_rows(torch.as_tensor(idx.astype(np.int64), device=dev),
                         torch.as_tensor(val, device=dev))
        cost_t = torch.as_tensor(cost, device=dev)
        iw_t = torch.as_tensor(iw, device=dev)
        losses = []
        for _ in range(int(self.num_passes)):
            ls, _ = online_pass(w, g2, plan, cost_t, self.learning_rate,
                                loss="bandit", wt=iw_t)
            losses.append(float(torch.mean(ls)))

        model = VowpalWabbitContextualBanditModel(
            weights=w.cpu().numpy(),
            shared_col=self.shared_col, features_col=self.features_col,
            prediction_col=self.prediction_col, device=self.device,
        )
        # off-policy evaluation of the learned greedy policy on the train log
        metrics = ContextualBanditMetrics()
        scores = model._predicted_costs(table)
        counts = np.array([len(a) for a in actions])
        for i in range(n):
            k = int(counts[i])
            greedy = int(np.argmin(scores[i][:k]))
            metrics.add(greedy == int(chosen[i]), float(cost[i]), float(prob[i]))
        model.set(train_metrics={
            "ips_estimate": metrics.ips_estimate(),
            "snips_estimate": metrics.snips_estimate(),
            "average_loss": losses[-1] if losses else None,
        })
        return model


@register_stage
class VowpalWabbitContextualBanditModel(Model):
    shared_col = Param("shared-context sparse features column", default="shared")
    features_col = Param("per-action sparse features list column",
                         default="features")
    prediction_col = Param("predicted-cost-per-action output column",
                           default="prediction")
    weights = ComplexParam("weight table (np array)")
    train_metrics = ComplexParam("IPS/SNIPS metrics from fit", default=None)
    device = Param(DEVICE_DOC, default=None)

    def _predicted_costs(self, table: Table) -> np.ndarray:
        shared = table[self.shared_col] if self.shared_col in table else None
        actions = table[self.features_col]
        idx, val, counts = _pad_actions(shared, actions)
        dev = resolve_device(self.device)
        w = torch.tensor(np.asarray(self.weights, np.float32), device=dev)
        scores = _cb_scores(w, torch.as_tensor(idx.astype(np.int64), device=dev),
                            torch.as_tensor(val, device=dev)).cpu().numpy()
        out = np.empty(len(table), dtype=object)
        for i in range(len(table)):
            out[i] = scores[i, : counts[i]].astype(np.float32)
        return out

    def _transform(self, table: Table) -> Table:
        return table.with_column(self.prediction_col,
                                 self._predicted_costs(table))
