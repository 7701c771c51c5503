"""TrainClassifier / TrainRegressor: auto-featurizing estimator wrappers.

Reference: core train/TrainClassifier.scala:49-278 and TrainRegressor.scala:
20-181 — reindex labels (ValueIndexer), Featurize input columns, fit the
wrapped learner, and return a model that carries the featurization so raw
tables score directly.  A copy of the JAX package's
`models/train_classifier.py` for this package, with a `device` Param that
goes to the default learner (`LogisticRegression` / `LinearRegression`,
on the card unless ``device="cpu"``); a learner passed as `model` keeps
its own.
"""
from __future__ import annotations

from typing import List

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table, find_unused_column_name
from ..featurize.featurize import Featurize
from ..featurize.value_indexer import ValueIndexer
from .linear import LogisticRegression, LinearRegression

__all__ = ["TrainClassifier", "TrainedClassifierModel",
           "TrainRegressor", "TrainedRegressorModel"]


def _feature_cols(table: Table, label_col: str) -> List[str]:
    return [c for c in table.column_names if c != label_col]


@register_stage
class TrainClassifier(Estimator):
    model = ComplexParam("wrapped learner (default LogisticRegression)", default=None)
    label_col = Param("label column", default="label")
    features_col = Param("assembled features column", default="features")
    input_cols = Param("columns to featurize (default: all but label)", default=None)
    reindex_label = Param("apply ValueIndexer to labels", default=True,
                          converter=TypeConverters.to_bool)
    number_of_features = Param("hash dims for text cols", default=256,
                               converter=TypeConverters.to_int)
    device = Param("the default learner's device: 'cuda' (default) or "
                   "'cpu'", default=None)

    def _fit(self, table: Table) -> "TrainedClassifierModel":
        label = self.label_col
        feat_inputs = self.input_cols or _feature_cols(table, label)
        feat_inputs = [c for c in feat_inputs if c != self.features_col]

        label_model = None
        working = table
        if self.reindex_label:
            indexed_col = find_unused_column_name("__label_idx__", table.column_names)
            label_model = ValueIndexer(input_col=label, output_col=indexed_col).fit(table)
            working = label_model.transform(table)
            label = indexed_col

        featurizer = Featurize(
            input_cols=feat_inputs,
            output_col=self.features_col,
            number_of_features=self.number_of_features,
        ).fit(working)
        featurized = featurizer.transform(working)

        learner = self.model or LogisticRegression(device=self.device)
        learner = learner.copy({"features_col": self.features_col, "label_col": label})
        fitted = learner.fit(featurized)
        return TrainedClassifierModel(
            featurizer=featurizer,
            inner_model=fitted,
            label_model=label_model,
            label_col=self.label_col,
            features_col=self.features_col,
        )


@register_stage
class TrainedClassifierModel(Model):
    featurizer = ComplexParam("fitted FeaturizeModel")
    inner_model = ComplexParam("fitted learner model")
    label_model = ComplexParam("fitted ValueIndexerModel or None", default=None)
    label_col = Param("original label column", default="label")
    features_col = Param("features column", default="features")

    def _transform(self, table: Table) -> Table:
        out = self.featurizer.transform(table)
        out = self.inner_model.transform(out)
        # restore original label levels on predictions
        lm = self.label_model
        if lm is not None:
            cm = lm.levels
            pred_col = getattr(self.inner_model, "prediction_col", "prediction")
            preds = out[pred_col]
            restored = [cm.get_level(int(p)) for p in preds]
            out = out.with_column(pred_col, restored, meta={"categorical": cm})
        return out


@register_stage
class TrainRegressor(Estimator):
    model = ComplexParam("wrapped learner (default LinearRegression)", default=None)
    label_col = Param("label column", default="label")
    features_col = Param("assembled features column", default="features")
    input_cols = Param("columns to featurize (default: all but label)", default=None)
    number_of_features = Param("hash dims for text cols", default=256,
                               converter=TypeConverters.to_int)
    device = Param("the default learner's device: 'cuda' (default) or "
                   "'cpu'", default=None)

    def _fit(self, table: Table) -> "TrainedRegressorModel":
        label = self.label_col
        feat_inputs = self.input_cols or _feature_cols(table, label)
        feat_inputs = [c for c in feat_inputs if c != self.features_col]
        featurizer = Featurize(
            input_cols=feat_inputs,
            output_col=self.features_col,
            number_of_features=self.number_of_features,
        ).fit(table)
        featurized = featurizer.transform(table)
        learner = self.model or LinearRegression(device=self.device)
        learner = learner.copy({"features_col": self.features_col, "label_col": label})
        fitted = learner.fit(featurized)
        return TrainedRegressorModel(
            featurizer=featurizer, inner_model=fitted,
            label_col=label, features_col=self.features_col,
        )


@register_stage
class TrainedRegressorModel(Model):
    featurizer = ComplexParam("fitted FeaturizeModel")
    inner_model = ComplexParam("fitted learner model")
    label_col = Param("label column", default="label")
    features_col = Param("features column", default="features")

    def _transform(self, table: Table) -> Table:
        return self.inner_model.transform(self.featurizer.transform(table))
