"""ComputeModelStatistics / ComputePerInstanceStatistics: evaluators.

Reference: core train/ComputeModelStatistics.scala:58-517 (confusion matrix,
precision/recall/accuracy/AUC, MSE/RMSE/R2/MAE, per-class metrics) and
ComputePerInstanceStatistics.scala:45 (per-row log-loss / L1 / L2);
metric names follow core/metrics/MetricConstants.scala.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.registry import register_stage
from ..core.schema import Table

__all__ = ["ComputeModelStatistics", "ComputePerInstanceStatistics",
           "roc_auc", "confusion_matrix"]


def confusion_matrix(labels: np.ndarray, preds: np.ndarray, n: int) -> np.ndarray:
    cm = np.zeros((n, n), dtype=np.int64)
    for t, p in zip(labels.astype(int), preds.astype(int)):
        cm[t, p] += 1
    return cm


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary AUC by rank statistic (ties averaged)."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


@register_stage
class ComputeModelStatistics(Transformer):
    label_col = Param("label column", default="label")
    scores_col = Param("probability/scores column (classification)", default="scores")
    scored_labels_col = Param("prediction column", default="prediction")
    evaluation_metric = Param("classification|regression|all", default="all")

    def _classification(self, table: Table) -> Dict[str, float]:
        raw_labels = np.asarray(table[self.label_col], dtype=np.float64)
        raw_preds = np.asarray(table[self.scored_labels_col], dtype=np.float64)
        # remap arbitrary class values (e.g. {-1, 1}) to contiguous indices —
        # direct integer indexing would wrap negatives silently
        classes = np.unique(np.concatenate([raw_labels, raw_preds]))
        index = {v: i for i, v in enumerate(classes.tolist())}
        labels = np.array([index[v] for v in raw_labels.tolist()], dtype=np.float64)
        preds = np.array([index[v] for v in raw_preds.tolist()], dtype=np.float64)
        n_classes = len(classes)
        cm = confusion_matrix(labels, preds, n_classes)
        total = cm.sum()
        acc = float(np.trace(cm)) / total if total else float("nan")
        # macro precision/recall, per-class safe division
        with np.errstate(divide="ignore", invalid="ignore"):
            prec_pc = np.diag(cm) / cm.sum(axis=0)
            rec_pc = np.diag(cm) / cm.sum(axis=1)
        precision = float(np.nanmean(prec_pc))
        recall = float(np.nanmean(rec_pc))
        metrics = {
            "accuracy": acc,
            "precision": precision,
            "recall": recall,
            "confusion_matrix": cm.astype(np.float64),
        }
        if n_classes == 2 and self.scores_col in table:
            scores = table[self.scores_col]
            if scores.dtype == object:
                s = np.asarray([np.asarray(v).ravel()[-1] for v in scores])
            elif scores.ndim > 1:
                s = np.asarray(scores)[:, 1]
            else:
                s = np.asarray(scores)
            metrics["AUC"] = roc_auc(labels.astype(int), s.astype(np.float64))
        return metrics

    def _regression(self, table: Table) -> Dict[str, float]:
        y = np.asarray(table[self.label_col], dtype=np.float64)
        p = np.asarray(table[self.scored_labels_col], dtype=np.float64)
        err = y - p
        mse = float(np.mean(err**2))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        return {
            "mse": mse,
            "rmse": float(np.sqrt(mse)),
            "mae": float(np.mean(np.abs(err))),
            "r2": 1.0 - float(np.sum(err**2)) / ss_tot if ss_tot > 0 else float("nan"),
        }

    def _transform(self, table: Table) -> Table:
        mode = self.evaluation_metric
        metrics: Dict[str, object] = {}
        labels = np.asarray(table[self.label_col], dtype=np.float64)
        preds = np.asarray(table[self.scored_labels_col], dtype=np.float64)
        looks_classification = (
            np.allclose(labels, np.round(labels)) and np.allclose(preds, np.round(preds))
            and len(np.unique(labels)) <= 50
        )
        if mode == "classification" or (mode == "all" and looks_classification):
            metrics.update(self._classification(table))
        if mode == "regression" or (mode == "all" and not looks_classification):
            metrics.update(self._regression(table))
        return Table({k: [v] for k, v in metrics.items()})


@register_stage
class ComputePerInstanceStatistics(Transformer):
    """Per-row metrics (ComputePerInstanceStatistics.scala:45): log-loss for
    classification (needs scores), L1/L2 for regression."""

    label_col = Param("label column", default="label")
    scores_col = Param("probability column", default="scores")
    scored_labels_col = Param("prediction column", default="prediction")
    evaluation_metric = Param("classification|regression", default="regression")

    def _transform(self, table: Table) -> Table:
        y = np.asarray(table[self.label_col], dtype=np.float64)
        if self.evaluation_metric == "classification":
            scores = table[self.scores_col]
            probs = (np.stack([np.asarray(v) for v in scores])
                     if scores.dtype == object else np.asarray(scores))
            eps = 1e-15
            ll = -np.log(np.clip(probs[np.arange(len(y)), y.astype(int)], eps, 1.0))
            return table.with_column("log_loss", ll)
        p = np.asarray(table[self.scored_labels_col], dtype=np.float64)
        table = table.with_column("L1_loss", np.abs(y - p))
        return table.with_column("L2_loss", (y - p) ** 2)
