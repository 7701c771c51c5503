"""RankingTrainValidationSplit: per-user holdout + param-grid search.

Reference: core recommendation/RankingTrainValidationSplit.scala (354 LoC) —
stratified-by-user train/validation split, sweep a param grid over the
wrapped recommender, keep the best by RankingEvaluator metric.

A copy of the JAX package's `recommendation/tvs.py` for this package.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table
from .ranking import RankingAdapter, RankingEvaluator

__all__ = ["RankingTrainValidationSplit", "RankingTrainValidationSplitModel"]


def per_user_split(table: Table, user_col: str, train_ratio: float,
                   seed: int = 0):
    """Stratified split: every user keeps ~train_ratio of their events in
    train (min 1), the rest go to validation."""
    users = np.asarray(table[user_col])
    rng = np.random.default_rng(seed)
    train_mask = np.zeros(len(table), bool)
    for u in np.unique(users):
        idx = np.nonzero(users == u)[0]
        perm = rng.permutation(idx)
        n_train = max(int(round(len(idx) * train_ratio)), 1)
        train_mask[perm[:n_train]] = True
    return table.filter(train_mask), table.filter(~train_mask)


@register_stage
class RankingTrainValidationSplit(Estimator):
    estimator = ComplexParam("recommender Estimator to tune")
    param_grid = ComplexParam("list of param dicts to sweep", default=None)
    evaluator = ComplexParam("RankingEvaluator", default=None)
    train_ratio = Param("per-user train fraction", default=0.75,
                        converter=TypeConverters.to_float)
    user_col = Param("user index column", default="user")
    item_col = Param("item index column", default="item")
    rating_col = Param("rating column", default="rating")
    seed = Param("split seed", default=0, converter=TypeConverters.to_int)

    def _fit(self, table: Table) -> "RankingTrainValidationSplitModel":
        evaluator: RankingEvaluator = (
            self.get_or_default("evaluator") or RankingEvaluator()
        )
        grid: List[Dict[str, Any]] = self.get_or_default("param_grid") or [{}]
        train, valid = per_user_split(
            table, self.user_col, float(self.train_ratio), int(self.seed)
        )
        best_metric, best_model, metrics = None, None, []
        larger_better = evaluator.is_larger_better()
        for params in grid:
            est = self.estimator.copy(params)
            adapter = RankingAdapter(
                recommender=est, k=evaluator.k,
                user_col=self.user_col, item_col=self.item_col,
                rating_col=self.rating_col,
            )
            adapter_model = adapter.fit(train)
            ranked = adapter_model.transform(valid)
            m = evaluator.evaluate(ranked)
            metrics.append(m)
            better = (
                best_metric is None
                or (m > best_metric if larger_better else m < best_metric)
            )
            if better:
                best_metric = m
                best_model = adapter_model.recommender_model
        return RankingTrainValidationSplitModel(
            best_model=best_model,
            validation_metrics=metrics,
        )


@register_stage
class RankingTrainValidationSplitModel(Model):
    best_model = ComplexParam("winning fitted recommender model")
    validation_metrics = ComplexParam("metric per grid point", default=None)

    def _transform(self, table: Table) -> Table:
        return self.best_model.transform(table)

    def recommend_for_all_users(self, k: int = 10) -> Table:
        return self.best_model.recommend_for_all_users(k)
