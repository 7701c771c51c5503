"""AutoML: hyperparameter tuning + model selection.

Reference: core automl/ (~700 LoC: TuneHyperparameters.scala:36-254,
HyperparamBuilder.scala, ParamSpace.scala, FindBestModel.scala:50-194).

A copy of the JAX package's `automl/` for this package (host code, as
there).
"""
from .find_best import BestModel, FindBestModel
from .param_space import (
    DiscreteHyperParam,
    FloatRangeHyperParam,
    GridSpace,
    HyperparamBuilder,
    IntRangeHyperParam,
    LogRangeHyperParam,
    RandomSpace,
)
from .tune import (
    METRIC_LARGER_BETTER,
    TuneHyperparameters,
    TuneHyperparametersModel,
    evaluate_model,
)

__all__ = [
    "TuneHyperparameters",
    "TuneHyperparametersModel",
    "FindBestModel",
    "BestModel",
    "HyperparamBuilder",
    "GridSpace",
    "RandomSpace",
    "DiscreteHyperParam",
    "IntRangeHyperParam",
    "FloatRangeHyperParam",
    "LogRangeHyperParam",
    "evaluate_model",
    "METRIC_LARGER_BETTER",
]
