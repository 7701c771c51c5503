"""GBDT estimators on the Table/stage contract.

API parity with the reference's LightGBMClassifier/Regressor/Ranker facades
(lightgbm/LightGBMClassifier.scala:26-209, LightGBMRegressor.scala,
LightGBMRanker.scala, params/LightGBMParams.scala) — same param surface
(numLeaves/boostingType/parallelism/numBatches/earlyStoppingRound/...),
same model methods (saveNativeModel, getFeatureImportances, predictRaw/
predictProbability/predictLeaf) — the counterpart of the JAX package's
`gbdt/estimators.py`, training on the device histogram engine (the
`device` Param: the card unless 'cpu' is asked for).  `LightGBMClassifier`
etc. are provided as aliases for drop-in migration.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table, features_matrix
from .boosting import Booster, TrainConfig
from .sparse import CSRMatrix, SparseBinMapper

__all__ = [
    "GBDTClassifier", "GBDTClassificationModel",
    "GBDTRegressor", "GBDTRegressionModel",
    "GBDTRanker", "GBDTRankerModel",
    "LightGBMClassifier", "LightGBMRegressor", "LightGBMRanker",
]


def _is_sparse_column(col: np.ndarray) -> bool:
    """Object column of (indices, values) pairs — the hashed namespace
    format produced by online.featurizer.VowpalWabbitFeaturizer."""
    return (col.dtype == object and len(col) > 0
            and isinstance(col[0], tuple) and len(col[0]) == 2
            and isinstance(col[0][0], np.ndarray))


def _features_matrix(col: np.ndarray, meta: Optional[dict] = None,
                     booster: Optional[Booster] = None):
    """Dense [N, F] matrix, or a CSRMatrix for hashed sparse columns (the
    CSR dataset path, reference dataset/DatasetAggregator.scala:69-515)."""
    if _is_sparse_column(col):
        nf = None
        if meta and "num_bits" in meta:
            nf = 1 << int(meta["num_bits"])
        elif booster is not None and isinstance(booster.bin_mapper, SparseBinMapper):
            nf = booster.bin_mapper.num_features_
        return CSRMatrix.from_pairs_column(col, num_features=nf)
    return features_matrix(col, dtype=np.float64)


class _GBDTParams:
    """Shared param surface (params/LightGBMParams.scala)."""

    features_col = Param("features column", default="features")
    label_col = Param("label column", default="label")
    prediction_col = Param("prediction column", default="prediction")
    weight_col = Param("optional sample-weight column", default="")
    validation_indicator_col = Param(
        "optional bool column marking validation rows", default="")
    init_score_col = Param("optional init score column", default="")

    num_iterations = Param("boosting rounds", default=100, converter=TypeConverters.to_int)
    learning_rate = Param("shrinkage", default=0.1, converter=TypeConverters.to_float)
    num_leaves = Param("max leaves per tree", default=31, converter=TypeConverters.to_int)
    max_depth = Param("max tree depth (-1 = none)", default=-1, converter=TypeConverters.to_int)
    max_bin = Param("histogram bins per feature", default=255, converter=TypeConverters.to_int)
    min_data_in_leaf = Param("min rows per leaf", default=20, converter=TypeConverters.to_int)
    min_sum_hessian_in_leaf = Param("min hessian per leaf", default=1e-3,
                                    converter=TypeConverters.to_float)
    lambda_l1 = Param("L1 regularization", default=0.0, converter=TypeConverters.to_float)
    lambda_l2 = Param("L2 regularization", default=0.0, converter=TypeConverters.to_float)
    feature_fraction = Param("per-tree feature subsample", default=1.0,
                             converter=TypeConverters.to_float)
    bagging_fraction = Param("row subsample", default=1.0, converter=TypeConverters.to_float)
    bagging_freq = Param("bag every k iterations", default=0, converter=TypeConverters.to_int)
    boosting_type = Param("gbdt|rf|dart|goss", default="gbdt")
    parallelism = Param("serial|data_parallel|voting_parallel "
                        "(tree_learner parity, LightGBMParams.scala:16-21)",
                        default="data_parallel")
    top_k = Param("voting-parallel top-k features", default=20, converter=TypeConverters.to_int)
    early_stopping_round = Param("stop after k rounds without improvement", default=0,
                                 converter=TypeConverters.to_int)
    categorical_slot_indexes = Param("categorical feature slots", default=[],
                                     converter=TypeConverters.to_list_int)
    num_batches = Param("split data into k sequential warm-started batches "
                        "(LightGBMBase.scala:46-66)", default=0,
                        converter=TypeConverters.to_int)
    drop_rate = Param("dart drop rate", default=0.1, converter=TypeConverters.to_float)
    skip_drop = Param("dart skip-drop prob", default=0.5, converter=TypeConverters.to_float)
    top_rate = Param("goss top rate", default=0.2, converter=TypeConverters.to_float)
    other_rate = Param("goss other rate", default=0.1, converter=TypeConverters.to_float)
    seed = Param("random seed", default=0, converter=TypeConverters.to_int)
    device = Param("'cuda' (default) or 'cpu'; without CUDA only an explicit "
                   "'cpu' runs", default=None)
    delegate = ComplexParam("GBDTDelegate with before/after-iteration hooks "
                            "and dynamic learning rate "
                            "(LightGBMDelegate.scala); runtime-only, not "
                            "persisted", default=None, transient=True)

    def _base_config(self, **overrides) -> TrainConfig:
        cfg = TrainConfig(
            num_iterations=self.num_iterations,
            learning_rate=self.learning_rate,
            num_leaves=self.num_leaves,
            max_depth=self.max_depth,
            max_bin=self.max_bin,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian=self.min_sum_hessian_in_leaf,
            lambda_l1=self.lambda_l1,
            lambda_l2=self.lambda_l2,
            feature_fraction=self.feature_fraction,
            bagging_fraction=self.bagging_fraction,
            bagging_freq=self.bagging_freq,
            boosting_type=self.boosting_type,
            parallelism=self.parallelism,
            top_k=self.top_k,
            early_stopping_round=self.early_stopping_round,
            categorical_features=list(self.categorical_slot_indexes),
            drop_rate=self.drop_rate,
            skip_drop=self.skip_drop,
            top_rate=self.top_rate,
            other_rate=self.other_rate,
            seed=self.seed,
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg

    def _split_data(self, table: Table):
        x = _features_matrix(table[self.features_col],
                             meta=table.get_meta(self.features_col))
        y = np.asarray(table[self.label_col], np.float64)
        w = (np.asarray(table[self.weight_col], np.float64)
             if self.weight_col and self.weight_col in table else None)
        eval_set = None
        vcol = self.validation_indicator_col
        if vcol and vcol in table:
            vmask = np.asarray(table[vcol], bool)
            eval_set = [("valid", x[vmask], y[vmask])]
            x, y = x[~vmask], y[~vmask]
            if w is not None:
                w = w[~vmask]
        return x, y, w, eval_set

    def _resolve_mesh(self):
        """Default mesh for the distributed tree learners: every rank of
        the process group on the data axis (LightGBMParams.scala:16-21
        `parallelism`) when a group of more than one rank is up; serial
        mode and a single device run unsharded, as in the reference."""
        if self.parallelism not in ("data_parallel", "voting_parallel"):
            return None
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() <= 1:
            return None
        from ..parallel.mesh import make_mesh

        return make_mesh(device=self.device)

    def _train_booster(self, cfg: TrainConfig, x, y, w, eval_set,
                       group=None, mesh=None) -> Booster:
        """Single fit or numBatches warm-start chain."""
        if mesh is None:
            mesh = self._resolve_mesh()
        nb = self.num_batches
        delegate = self.get_or_default("delegate")
        if nb and nb > 1:
            rng = np.random.default_rng(self.seed)
            perm = rng.permutation(len(x))
            parts = np.array_split(perm, nb)
            booster = None
            for idx in parts:
                b = Booster(cfg)
                b.fit(x[idx], y[idx],
                      sample_weight=None if w is None else w[idx],
                      group=None if group is None else group[idx],
                      eval_set=eval_set, init_model=booster, mesh=mesh,
                      delegate=delegate, device=self.device)
                booster = b
            return booster
        booster = Booster(cfg)
        booster.fit(x, y, sample_weight=w, group=group, eval_set=eval_set,
                    mesh=mesh, delegate=delegate, device=self.device)
        return booster


class _GBDTModelBase(Model):
    features_col = Param("features column", default="features")
    prediction_col = Param("prediction column", default="prediction")
    model_string = ComplexParam("serialized booster (model_string)")

    _booster_cache: Optional[Booster] = None

    @property
    def booster(self) -> Booster:
        if getattr(self, "_booster_cache", None) is None:
            self._booster_cache = Booster.from_model_string(self.model_string)
        return self._booster_cache

    def save_native_model(self, path: str) -> None:
        """saveNativeModel parity (LightGBMBooster.scala:454)."""
        with open(path, "w") as f:
            f.write(self.model_string)

    def get_feature_importances(self, importance_type: str = "split") -> List[float]:
        return list(self.booster.feature_importances(importance_type))

    def predict_leaf(self, table: Table) -> np.ndarray:
        return self.booster.predict_leaf(
            _features_matrix(table[self.features_col], booster=self.booster))

    def features_shap(self, table: Table) -> np.ndarray:
        return self.booster.features_shap(
            _features_matrix(table[self.features_col], booster=self.booster))


@register_stage
class GBDTClassifier(Estimator, _GBDTParams):
    """LightGBMClassifier parity (lightgbm/LightGBMClassifier.scala:26)."""

    probability_col = Param("probability column", default="probability")
    raw_prediction_col = Param("raw score column", default="rawPrediction")
    objective = Param("binary|multiclass (auto-upgraded by label cardinality)",
                      default="binary")
    is_unbalance = Param("reweight positive class by neg/pos ratio", default=False,
                         converter=TypeConverters.to_bool)
    scale_pos_weight = Param("explicit positive-class weight", default=1.0,
                             converter=TypeConverters.to_float)

    def _fit(self, table: Table) -> "GBDTClassificationModel":
        x, y, w, eval_set = self._split_data(table)
        classes = np.unique(y.astype(np.int64))
        num_class = int(classes.max()) + 1
        objective = self.objective
        if num_class > 2 and objective == "binary":
            objective = "multiclass"
        spw = self.scale_pos_weight
        if self.is_unbalance and objective == "binary":
            pos = max(float((y > 0).sum()), 1.0)
            spw = float((len(y) - pos) / pos)
        cfg = self._base_config(
            objective=objective,
            num_class=num_class if objective in ("multiclass", "softmax") else 1,
            scale_pos_weight=spw,
        )
        booster = self._train_booster(cfg, x, y, w, eval_set)
        return GBDTClassificationModel(
            features_col=self.features_col,
            prediction_col=self.prediction_col,
            probability_col=self.probability_col,
            raw_prediction_col=self.raw_prediction_col,
            model_string=booster.model_string(),
        )


@register_stage
class GBDTClassificationModel(_GBDTModelBase):
    probability_col = Param("probability column", default="probability")
    raw_prediction_col = Param("raw score column", default="rawPrediction")

    def _transform(self, table: Table) -> Table:
        x = _features_matrix(table[self.features_col], booster=self.booster)
        b = self.booster
        raw = b._raw_scores(x)
        probs = b.objective.transform(raw)
        if probs.ndim == 1:  # binary -> [N, 2]
            probs = np.stack([1 - probs, probs], axis=1)
            raw = np.stack([-raw, raw], axis=1)
        preds = probs.argmax(axis=1).astype(np.float64)
        out = table.with_column(self.raw_prediction_col, np.asarray(raw, np.float64))
        out = out.with_column(self.probability_col, probs)
        return out.with_column(self.prediction_col, preds)


@register_stage
class GBDTRegressor(Estimator, _GBDTParams):
    """LightGBMRegressor parity (lightgbm/LightGBMRegressor.scala)."""

    objective = Param("regression|regression_l1|huber|fair|poisson|quantile|mape|tweedie",
                      default="regression")
    alpha = Param("huber/quantile alpha", default=0.9, converter=TypeConverters.to_float)
    tweedie_variance_power = Param("tweedie power in (1,2)", default=1.5,
                                   converter=TypeConverters.to_float)

    def _fit(self, table: Table) -> "GBDTRegressionModel":
        x, y, w, eval_set = self._split_data(table)
        cfg = self._base_config(
            objective=self.objective, alpha=self.alpha,
            tweedie_variance_power=self.tweedie_variance_power,
        )
        booster = self._train_booster(cfg, x, y, w, eval_set)
        return GBDTRegressionModel(
            features_col=self.features_col,
            prediction_col=self.prediction_col,
            model_string=booster.model_string(),
        )


@register_stage
class GBDTRegressionModel(_GBDTModelBase):
    def _transform(self, table: Table) -> Table:
        x = _features_matrix(table[self.features_col], booster=self.booster)
        return table.with_column(self.prediction_col, self.booster.score(x))


@register_stage
class GBDTRanker(Estimator, _GBDTParams):
    """LightGBMRanker parity (lightgbm/LightGBMRanker.scala): lambdarank
    over query groups given by group_col."""

    group_col = Param("query-group id column", default="group")
    max_position = Param("NDCG truncation", default=30, converter=TypeConverters.to_int)

    def _fit(self, table: Table) -> "GBDTRankerModel":
        x = _features_matrix(table[self.features_col],
                             meta=table.get_meta(self.features_col))
        y = np.asarray(table[self.label_col], np.float64)
        w = (np.asarray(table[self.weight_col], np.float64)
             if self.weight_col and self.weight_col in table else None)
        group = np.asarray(table[self.group_col])
        # factorize group ids
        _, group_ids = np.unique(group, return_inverse=True)
        cfg = self._base_config(objective="regression", max_position=self.max_position)
        booster = self._train_booster(cfg, x, y, w, None, group=group_ids)
        return GBDTRankerModel(
            features_col=self.features_col,
            prediction_col=self.prediction_col,
            model_string=booster.model_string(),
        )


@register_stage
class GBDTRankerModel(_GBDTModelBase):
    def _transform(self, table: Table) -> Table:
        x = _features_matrix(table[self.features_col], booster=self.booster)
        return table.with_column(self.prediction_col, self.booster._raw_scores(x))


# Drop-in aliases for reference users — registered under both names so
# registry lookups (and generated bindings) resolve the reference names too.
LightGBMClassifier = register_stage(GBDTClassifier, name="LightGBMClassifier")
LightGBMRegressor = register_stage(GBDTRegressor, name="LightGBMRegressor")
LightGBMRanker = register_stage(GBDTRanker, name="LightGBMRanker")
