"""Ranking evaluation: NDCG/MAP/precision/recall @k + the adapter stage.

Reference: core recommendation/RankingAdapter.scala (wraps a recommender so a
plain Estimator interface yields per-user (recommended, ground-truth) lists)
and RankingEvaluator.scala (SparkML RankingMetrics bridge: ndcgAt, map,
precisionAtk, recallAtK, diversityAtK, maxDiversity).

A copy of the JAX package's `recommendation/ranking.py` for this
package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table

__all__ = ["RankingEvaluator", "RankingAdapter", "RankingAdapterModel",
           "ndcg_at_k", "map_at_k", "precision_at_k", "recall_at_k"]


def _as_set(x) -> set:
    return set(int(v) for v in np.asarray(x).reshape(-1))


def ndcg_at_k(recommended: Sequence[int], relevant: Sequence[int], k: int) -> float:
    rel = _as_set(relevant)
    if not rel:
        return 0.0
    rec = list(recommended)[:k]
    dcg = sum(1.0 / np.log2(i + 2) for i, r in enumerate(rec) if int(r) in rel)
    ideal = sum(1.0 / np.log2(i + 2) for i in range(min(len(rel), k)))
    return float(dcg / ideal) if ideal > 0 else 0.0


def map_at_k(recommended: Sequence[int], relevant: Sequence[int], k: int) -> float:
    rel = _as_set(relevant)
    if not rel:
        return 0.0
    rec = list(recommended)[:k]
    hits, s = 0, 0.0
    for i, r in enumerate(rec):
        if int(r) in rel:
            hits += 1
            s += hits / (i + 1)
    return float(s / min(len(rel), k))


def precision_at_k(recommended, relevant, k: int) -> float:
    rel = _as_set(relevant)
    rec = list(recommended)[:k]
    if not rec:
        return 0.0
    return float(sum(1 for r in rec if int(r) in rel) / k)


def recall_at_k(recommended, relevant, k: int) -> float:
    rel = _as_set(relevant)
    if not rel:
        return 0.0
    rec = list(recommended)[:k]
    return float(sum(1 for r in rec if int(r) in rel) / len(rel))


_METRICS = {
    "ndcgAt": ndcg_at_k,
    "map": map_at_k,
    "precisionAtk": precision_at_k,
    "recallAtK": recall_at_k,
}


class RankingEvaluator:
    """Evaluate a Table of per-user (recommended, ground-truth) item lists.

    Reference: recommendation/RankingEvaluator.scala; metric names kept
    identical for parity.
    """

    def __init__(self, metric_name: str = "ndcgAt", k: int = 10,
                 prediction_col: str = "recommendations",
                 label_col: str = "ground_truth"):
        if metric_name not in _METRICS and metric_name != "diversityAtK":
            raise ValueError(f"unknown metric {metric_name!r}")
        self.metric_name = metric_name
        self.k = int(k)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, table: Table) -> float:
        recs = table[self.prediction_col]
        truth = table[self.label_col]
        if self.metric_name == "diversityAtK":
            shown = set()
            all_items = set()
            for i in range(len(table)):
                shown |= _as_set(list(recs[i])[: self.k])
                all_items |= _as_set(truth[i])
                all_items |= _as_set(recs[i])
            return float(len(shown) / max(len(all_items), 1))
        fn = _METRICS[self.metric_name]
        vals = [fn(recs[i], truth[i], self.k) for i in range(len(table))]
        return float(np.mean(vals)) if vals else 0.0

    def is_larger_better(self) -> bool:
        return True


@register_stage
class RankingAdapter(Estimator):
    """Wrap a recommender Estimator so fit/transform yields per-user
    (recommendations, ground_truth) lists ready for RankingEvaluator.

    Reference: recommendation/RankingAdapter.scala.
    """

    recommender = ComplexParam("the wrapped recommender Estimator")
    k = Param("recommendations per user", default=10,
              converter=TypeConverters.to_int)
    user_col = Param("user index column", default="user")
    item_col = Param("item index column", default="item")
    rating_col = Param("rating column", default="rating")
    min_rating_filter = Param("only items rated >= this count as relevant",
                              default=0, converter=TypeConverters.to_float)

    def _fit(self, table: Table) -> "RankingAdapterModel":
        model = self.recommender.fit(table)
        return RankingAdapterModel(
            recommender_model=model, k=int(self.k),
            user_col=self.user_col, item_col=self.item_col,
            rating_col=self.rating_col,
            min_rating_filter=float(self.min_rating_filter),
        )


@register_stage
class RankingAdapterModel(Model):
    recommender_model = ComplexParam("fitted recommender model")
    k = Param("recommendations per user", default=10,
              converter=TypeConverters.to_int)
    user_col = Param("user index column", default="user")
    item_col = Param("item index column", default="item")
    rating_col = Param("rating column", default="rating")
    min_rating_filter = Param("relevance threshold", default=0.0,
                              converter=TypeConverters.to_float)

    def _transform(self, table: Table) -> Table:
        """Emit one row per user present in `table`: top-k recs + the user's
        observed items (the eval ground truth)."""
        model = self.recommender_model
        recs = model.recommend_for_all_users(int(self.k))
        users = np.asarray(table[self.user_col], np.int64)
        items = np.asarray(table[self.item_col], np.int64)
        ratings = (
            np.asarray(table[self.rating_col], np.float64)
            if self.rating_col in table
            else np.ones(len(table))
        )
        thresh = float(self.min_rating_filter)
        # one sort-and-split pass instead of a per-user scan of all rows
        relevant = ratings >= thresh
        order = np.argsort(users[relevant], kind="stable")
        sorted_users = users[relevant][order]
        sorted_items = items[relevant][order]
        uniq_rel, starts = np.unique(sorted_users, return_index=True)
        truth_map = {
            int(u): sorted_items[s:e]
            for u, s, e in zip(
                uniq_rel, starts, np.append(starts[1:], len(sorted_items))
            )
        }
        uniq = np.unique(users)
        rec_map = {int(u): r for u, r in zip(recs[self.user_col],
                                             recs["recommendations"])}
        out_recs = np.empty(len(uniq), dtype=object)
        out_truth = np.empty(len(uniq), dtype=object)
        for j, u in enumerate(uniq):
            out_truth[j] = truth_map.get(int(u), np.zeros(0, np.int64))
            out_recs[j] = rec_map.get(int(u), np.zeros(0, np.int64))
        return Table({
            self.user_col: uniq,
            "recommendations": out_recs,
            "ground_truth": out_truth,
        })
