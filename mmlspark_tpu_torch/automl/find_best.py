"""FindBestModel: evaluate fitted models on one metric, keep the winner.

Reference: core automl/FindBestModel.scala:50-194 (BestModel holds the
winning transformer + all evaluation results).

A copy of the JAX package's `automl/find_best.py` for this package.
"""
from __future__ import annotations

from ..core.params import ComplexParam, Param
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table
from .tune import METRIC_LARGER_BETTER, _select_best, evaluate_model

__all__ = ["FindBestModel", "BestModel"]


@register_stage
class FindBestModel(Estimator):
    models = ComplexParam("fitted candidate Models")
    evaluation_metric = Param("metric name", default="accuracy")
    label_col = Param("label column", default="label")

    def _fit(self, table: Table) -> "BestModel":
        metric = self.evaluation_metric
        larger = METRIC_LARGER_BETTER.get(metric, True)
        vals = [
            evaluate_model(m, table, metric, self.label_col)
            for m in self.models
        ]
        best_i = _select_best(vals, larger)
        return BestModel(
            best_model=self.models[best_i],
            best_model_metrics={"metric": metric, "value": vals[best_i]},
            all_model_metrics=[
                {"estimator": type(m).__name__, "value": v}
                for m, v in zip(self.models, vals)
            ],
        )


@register_stage
class BestModel(Model):
    best_model = ComplexParam("winning fitted model")
    best_model_metrics = ComplexParam("winning metric", default=None)
    all_model_metrics = ComplexParam("all evaluation results", default=None)

    def _transform(self, table: Table) -> Table:
        return self.best_model.transform(table)
