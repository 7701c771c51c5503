"""TuneHyperparameters: k-fold CV search, thread-parallel trials.

Reference: core automl/TuneHyperparameters.scala:36-254 (randomized/grid
search over wrapped estimators, k-fold cross validation, `parallelism`
Futures pool, best-model extraction).

Trials run in a thread pool like the reference's Futures; each trial's
fits share the card, whose stream serializes their kernels while the host
side (featurization, binning) overlaps.  Trials of the linear learners in
threads rely on `models/linear._full_f32`'s depth count, which keeps
full-f32 products on while any fit is inside it.  A copy of the JAX
package's `automl/tune.py` for this package, without its guard for
XLA's virtual CPU mesh, which has no counterpart here.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Tuple

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table

__all__ = ["TuneHyperparameters", "TuneHyperparametersModel",
           "evaluate_model", "METRIC_LARGER_BETTER", "_select_best"]

METRIC_LARGER_BETTER = {
    "accuracy": True, "precision": True, "recall": True, "AUC": True,
    "mse": False, "rmse": False, "mae": False, "r2": True,
}


def evaluate_model(model: Model, table: Table, metric: str,
                   label_col: str = "label") -> float:
    """Score a fitted model on a table with one named metric (the
    ComputeModelStatistics bridge used across automl)."""
    from ..models.statistics import ComputeModelStatistics

    scored = model.transform(table)
    mode = "regression" if metric in ("mse", "rmse", "mae", "r2") else "classification"
    pred_col = "prediction"
    scores_col = "probability" if "probability" in scored else "scores"
    stats = ComputeModelStatistics(
        label_col=label_col, scored_labels_col=pred_col,
        scores_col=scores_col, evaluation_metric=mode,
    ).transform(scored)
    if metric not in stats:
        raise ValueError(
            f"metric {metric!r} not produced; available: {stats.column_names}"
        )
    return float(stats[metric][0])


def _select_best(metrics: List[float], larger_better: bool) -> int:
    """Index of the best finite metric; NaN trials never win."""
    vals = np.asarray(metrics, np.float64)
    if np.all(np.isnan(vals)):
        raise ValueError("every candidate produced a NaN metric")
    return int(np.nanargmax(vals) if larger_better else np.nanargmin(vals))


def _kfold_indices(n: int, k: int, seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [perm[i::k] for i in range(k)]


@register_stage
class TuneHyperparameters(Estimator):
    """Sweep (estimator, param-map) candidates with k-fold CV.

    `models` is a list of Estimators; `param_space` an object with
    .param_maps() (GridSpace/RandomSpace) applied to every estimator, or None
    to evaluate the estimators as-is.
    """

    models = ComplexParam("candidate Estimators")
    param_space = ComplexParam("GridSpace/RandomSpace over estimator params",
                               default=None)
    evaluation_metric = Param("metric name", default="accuracy")
    label_col = Param("label column", default="label")
    num_folds = Param("k-fold CV folds", default=3,
                      converter=TypeConverters.to_int)
    parallelism = Param("concurrent trials", default=4,
                        converter=TypeConverters.to_int)
    seed = Param("fold/search seed", default=0, converter=TypeConverters.to_int)

    def _fit(self, table: Table) -> "TuneHyperparametersModel":
        metric = self.evaluation_metric
        larger = METRIC_LARGER_BETTER.get(metric, True)
        space = self.get_or_default("param_space")
        param_maps = list(space.param_maps()) if space is not None else [{}]
        candidates: List[Tuple[Estimator, Dict[str, Any]]] = [
            (est, pm) for est in self.models for pm in param_maps
        ]
        folds = _kfold_indices(len(table), int(self.num_folds), int(self.seed))

        def run_trial(cand: Tuple[Estimator, Dict[str, Any]]) -> float:
            est, pm = cand
            vals = []
            for i in range(len(folds)):
                test_idx = folds[i]
                train_idx = np.concatenate(
                    [folds[j] for j in range(len(folds)) if j != i]
                )
                trial_est = est.copy(pm)
                model = trial_est.fit(table.take(train_idx))
                vals.append(
                    evaluate_model(model, table.take(test_idx), metric,
                                   self.label_col)
                )
            return float(np.mean(vals))

        par = int(self.parallelism)
        with ThreadPoolExecutor(max_workers=par) as pool:
            metrics = list(pool.map(run_trial, candidates))

        best_i = _select_best(metrics, larger)
        best_est, best_pm = candidates[best_i]
        best_model = best_est.copy(best_pm).fit(table)
        return TuneHyperparametersModel(
            best_model=best_model,
            best_metric=float(metrics[best_i]),
            all_metrics=[
                {"params": pm, "metric": m,
                 "estimator": type(est).__name__}
                for (est, pm), m in zip(candidates, metrics)
            ],
        )


@register_stage
class TuneHyperparametersModel(Model):
    best_model = ComplexParam("winning fitted model")
    best_metric = Param("winning CV metric", default=None,
                        converter=TypeConverters.to_float)
    all_metrics = ComplexParam("trial log", default=None)

    def _transform(self, table: Table) -> Table:
        return self.best_model.transform(table)
