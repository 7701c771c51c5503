"""Booster: the iteration loop over TreeGrower — gbdt / rf / dart / goss.

The counterpart of the JAX package's `gbdt/boosting.py`: the reference's
training core (lightgbm/TrainUtils.scala trainCore :92-159 — iteration
loop, early stopping, eval logging, custom fobj) plus boosting-mode
semantics from params/TrainParams.scala (boostingType gbdt|rf|dart|goss).
Histograms and split search run on the device (`fit(device=)`, the card
unless 'cpu' is asked for); gradients and the loop are host-side, as
trainCore's loop is.  `model_string()` is the JAX package's format,
so a forest trained by either package loads in the other.

Distributed: pass a mesh and, under `parallelism="data_parallel"` or
`"voting_parallel"`, rows shard over its data axis and the ranks'
histograms are all-reduced (histogram.py) — the reference's
"data_parallel" / "voting_parallel".  Every rank runs the same host
grower on the same full host arrays, so the trees are identical on every
rank by construction.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .binning import BinMapper
from .histogram import HistogramBuilder
from .objectives import Objective, get_objective, lambdarank_grad
from .sparse import (
    CSRMatrix,
    SparseBinMapper,
    SparseBinnedView,
    SparseHistogramBuilder,
    effective_sparse_max_bin,
)
from .tree import GrowerConfig, Tree, TreeGrower, predict_forest, tree_arrays_for_jit


def _tree_out(tree: Tree, ex) -> np.ndarray:
    """Per-tree output for either representation: raw float rows (dense) or
    a pre-binned SparseBinnedView (bin codes are monotone in value, so the
    bin-threshold traversal is exact)."""
    if isinstance(ex, SparseBinnedView):
        return tree.predict_binned(ex)
    return tree.predict_raw(ex)

__all__ = ["TrainConfig", "Booster", "EvalRecord"]


@dataclass
class TrainConfig:
    """Param-string analog of params/TrainParams.scala (rendered key=value
    for the native engine there; a plain dataclass here)."""

    objective: str = "regression"
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = -1
    max_bin: int = 255
    min_data_in_leaf: int = 20
    min_sum_hessian: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain: float = 0.0
    feature_fraction: float = 1.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    boosting_type: str = "gbdt"          # gbdt | rf | dart | goss
    # dart
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    # goss
    top_rate: float = 0.2
    other_rate: float = 0.1
    # multiclass / ranking / objective knobs
    num_class: int = 1
    alpha: float = 0.9
    fair_c: float = 1.0
    tweedie_variance_power: float = 1.5
    sigmoid: float = 1.0
    scale_pos_weight: float = 1.0
    max_position: int = 30
    # distributed
    parallelism: str = "serial"          # serial | data_parallel | voting_parallel
    top_k: int = 20
    # control
    early_stopping_round: int = 0
    categorical_features: Sequence[int] = field(default_factory=list)
    seed: int = 0
    verbosity: int = 0

    def grower_config(self) -> GrowerConfig:
        return GrowerConfig(
            num_leaves=self.num_leaves,
            max_depth=self.max_depth,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian=self.min_sum_hessian,
            lambda_l1=self.lambda_l1,
            lambda_l2=self.lambda_l2,
            min_gain=self.min_gain,
            feature_fraction=self.feature_fraction,
            voting=self.parallelism == "voting_parallel",
            top_k=self.top_k,
        )


@dataclass
class EvalRecord:
    iteration: int
    dataset: str
    metric: str
    value: float


class Booster:
    """Trained forest + training entry points.

    Mirrors LightGBMBooster (lightgbm/booster/LightGBMBooster.scala:14-574):
    score/predictLeaf/featuresShap surface, model-string save/load,
    feature importances, warm start (`init_model`), iteration truncation.
    """

    def __init__(self, config: TrainConfig, bin_mapper: Optional[BinMapper] = None,
                 device=None):
        self.config = config
        # where fit builds histograms and raw_scores_jit predicts (None:
        # the card); not part of the model string
        self.device = device
        self.bin_mapper = bin_mapper
        self.trees: List[Tree] = []            # flat list; multiclass: C trees per iter
        self.tree_weights: List[float] = []
        self.init_score: np.ndarray = np.zeros(1)
        self.objective: Objective = get_objective(
            config.objective, num_class=max(config.num_class, 1),
            alpha=config.alpha, fair_c=config.fair_c,
            tweedie_variance_power=config.tweedie_variance_power,
            sigmoid=config.sigmoid, scale_pos_weight=config.scale_pos_weight,
        )
        self.best_iteration: int = -1
        self.eval_history: List[EvalRecord] = []
        self._forest_cache = None

    # ---- helpers -------------------------------------------------------
    @property
    def num_class(self) -> int:
        return max(self.objective.num_class, 1)

    @property
    def num_iterations_trained(self) -> int:
        return len(self.trees) // self.num_class

    def _prepare_x(self, x: np.ndarray) -> np.ndarray:
        """Categorical columns are split on bin codes; encode them once.
        CSR input is pre-binned through the sparse mapper instead (trees
        then traverse on bin codes, see _tree_out)."""
        if isinstance(x, CSRMatrix):
            if not isinstance(self.bin_mapper, SparseBinMapper):
                raise ValueError("booster was trained dense; densify the "
                                 "CSR input or retrain on CSRMatrix")
            return self.bin_mapper.transform(x)
        x = np.asarray(x, np.float64)
        if self.bin_mapper is not None:
            x = self.bin_mapper.encode_categoricals(x)
        return x

    def _raw_scores(self, x, num_iteration: Optional[int] = None) -> np.ndarray:
        """[N] or [N, C] raw margin."""
        c = self.num_class
        n = len(x)
        x = self._prepare_x(x)
        out = np.tile(self.init_score.reshape(1, -1), (n, 1)).astype(np.float64)
        limit = len(self.trees) if num_iteration is None else num_iteration * c
        for i, tree in enumerate(self.trees[:limit]):
            out[:, i % c] += self.tree_weights[i] * _tree_out(tree, x)
        return out[:, 0] if c == 1 else out

    def raw_scores_jit(self, x, device=None) -> np.ndarray:
        """Forest prediction on the device (`predict_forest`; single-output
        objectives): the booster's device unless `device` is given."""
        if isinstance(x, CSRMatrix):
            return self._raw_scores(x)
        if self.num_class != 1 or not self.trees:
            return self._raw_scores(np.asarray(x))
        if self._forest_cache is None:
            arrs = tree_arrays_for_jit(self.trees)
            md = max(t.max_depth for t in self.trees)
            self._forest_cache = (arrs, np.asarray(self.tree_weights, np.float32), max(md, 1))
        arrs, w, md = self._forest_cache
        dev = resolve_device(self.device if device is None else device)
        put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        res = predict_forest({k: put(v) for k, v in arrs.items()},
                             put(np.asarray(self._prepare_x(x), np.float32)),
                             put(w), md)
        return res.cpu().numpy().astype(np.float64) + float(self.init_score[0])

    def score(self, x, num_iteration: Optional[int] = None) -> np.ndarray:
        """User-facing prediction (probabilities for binary/multiclass)."""
        if not isinstance(x, CSRMatrix):
            x = np.asarray(x, np.float64)
        return self.objective.transform(self._raw_scores(x, num_iteration))

    def predict_leaf(self, x) -> np.ndarray:
        """[N, T] terminal-leaf indices (predictLeaf parity)."""
        x = self._prepare_x(x)
        if isinstance(x, SparseBinnedView):
            return np.stack([t.predict_leaf_index_binned(x) for t in self.trees],
                            axis=1)
        return np.stack([t.predict_leaf_index(x) for t in self.trees], axis=1)

    def feature_importances(self, importance_type: str = "split") -> np.ndarray:
        f = self.bin_mapper.num_features_ if self.bin_mapper else max(
            (int(t.split_feature.max()) + 1) for t in self.trees
        )
        out = np.zeros(f)
        for t in self.trees:
            internal = t.split_feature >= 0
            if importance_type == "gain":
                np.add.at(out, t.split_feature[internal], t.gain[internal])
            else:
                np.add.at(out, t.split_feature[internal], 1.0)
        return out

    def features_shap(self, x) -> np.ndarray:
        """Per-feature contributions [N, F+1] (last = expected value), via
        SAABAS-style path attribution per tree (fast approximation of the
        reference's featuresShap; exact interventional SHAP lives in
        mmlspark_tpu.explainers)."""
        x = self._prepare_x(x)
        binned_input = isinstance(x, SparseBinnedView)
        n = len(x)
        f = self.bin_mapper.num_features_ if self.bin_mapper else x.shape[1]
        if n * (f + 1) > 200_000_000:
            raise ValueError(
                f"features_shap would materialize a dense [{n}, {f + 1}] "
                "contribution matrix; for high-dimensional hashed features "
                "attribute through mmlspark_tpu.explainers (KernelSHAP) or "
                "call on smaller row batches")
        out = np.zeros((n, f + 1))
        out[:, -1] = self.init_score.mean()
        for w, tree in zip(self.tree_weights, self.trees):
            if tree.num_nodes == 1:
                out[:, -1] += w * tree.value[0]
                continue
            # expected value per node from counts
            exp_val = np.zeros(tree.num_nodes)
            for i in range(tree.num_nodes - 1, -1, -1):
                if tree.split_feature[i] < 0:
                    exp_val[i] = tree.value[i]
                else:
                    l, r = tree.left[i], tree.right[i]
                    cl, cr = tree.count[l], tree.count[r]
                    tot = max(cl + cr, 1e-15)
                    exp_val[i] = (cl * exp_val[l] + cr * exp_val[r]) / tot
            node = np.zeros(n, np.int32)
            out[:, -1] += w * exp_val[0]
            for _ in range(tree.max_depth):
                sf = tree.split_feature[node]
                internal = sf >= 0
                if not internal.any():
                    break
                fx = x[np.arange(n), np.maximum(sf, 0)]
                if binned_input:
                    go_left = fx.astype(np.int32) <= tree.threshold_bin[node]
                else:
                    go_left = np.where(np.isnan(fx), True,
                                       fx <= tree.threshold_value[node])
                nxt = np.where(go_left, tree.left[node], tree.right[node])
                delta = exp_val[nxt] - exp_val[node]
                rows = np.where(internal)[0]
                np.add.at(out, (rows, sf[rows]), w * delta[rows])
                node = np.where(internal, nxt, node)
        return out

    # ---- training ------------------------------------------------------
    def fit(
        self,
        x: np.ndarray,
        y: np.ndarray,
        sample_weight: Optional[np.ndarray] = None,
        group: Optional[np.ndarray] = None,
        eval_set: Optional[List[Tuple[str, np.ndarray, np.ndarray]]] = None,
        fobj: Optional[Callable] = None,
        init_model: Optional["Booster"] = None,
        mesh=None,
        callbacks: Optional[List[Callable]] = None,
        delegate=None,
        device=None,
    ) -> "Booster":
        if device is not None:
            self.device = device
        cfg = self.config
        sparse = isinstance(x, CSRMatrix)
        if not sparse:
            x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        n = len(x)
        w = np.ones(n) if sample_weight is None else np.asarray(sample_weight, np.float64)
        rng = np.random.default_rng(cfg.seed)

        if self.bin_mapper is None and init_model is not None \
                and init_model.bin_mapper is not None:
            # warm start inherits the bin boundaries/categorical codes so
            # inherited trees' threshold_bin stay valid on this data
            if sparse != isinstance(init_model.bin_mapper, SparseBinMapper):
                raise ValueError(
                    "warm start requires matching representations: the "
                    "init_model was trained "
                    + ("dense" if sparse else "sparse")
                    + " but this fit received "
                    + ("CSRMatrix" if sparse else "dense") + " input")
            self.bin_mapper = init_model.bin_mapper
        if self.bin_mapper is None:
            if sparse:
                if cfg.categorical_features:
                    raise ValueError(
                        "categorical_features are not supported on the "
                        "sparse (CSRMatrix) path — hashed features are "
                        "already indicator/count-valued; densify or drop "
                        "the categorical declaration")
                # CSR ingestion (DatasetAggregator.scala sparse variant):
                # bins capped so the [F, B, 3] histogram fits device memory
                self.bin_mapper = SparseBinMapper(
                    effective_sparse_max_bin(cfg.max_bin, x.shape[1],
                                             cfg.num_leaves),
                    seed=cfg.seed)
            else:
                self.bin_mapper = BinMapper(cfg.max_bin,
                                            categorical_features=cfg.categorical_features,
                                            seed=cfg.seed)
            self.bin_mapper.fit(x)
        binned = self.bin_mapper.transform(x)

        use_mesh = mesh if cfg.parallelism in ("data_parallel", "voting_parallel") else None
        builder_cls = SparseHistogramBuilder if sparse else HistogramBuilder
        builder = builder_cls(binned, self.bin_mapper.num_bins, mesh=use_mesh,
                              voting=cfg.parallelism == "voting_parallel",
                              top_k=cfg.top_k,
                              device=None if use_mesh is not None
                              else self.device)
        grower = TreeGrower(builder, cfg.grower_config(),
                            self.bin_mapper.bin_upper_value, rng)

        c = self.num_class
        is_rank = group is not None
        if init_model is not None and init_model.trees:
            # warm start (numBatches chaining, LightGBMBase.scala:46-66)
            self.trees = list(init_model.trees)
            self.tree_weights = list(init_model.tree_weights)
            self.init_score = np.array(init_model.init_score, np.float64)
            scores = init_model._raw_scores(x)
            scores = scores.reshape(n, c) if c > 1 else scores.reshape(n, 1)
        else:
            init = self.objective.init_score_fn(y, w) if not is_rank else 0.0
            self.init_score = np.atleast_1d(np.asarray(init, np.float64))
            scores = np.tile(self.init_score.reshape(1, -1), (n, 1))
        scores = scores.astype(np.float64)

        is_rf = cfg.boosting_type == "rf"
        is_dart = cfg.boosting_type == "dart"
        is_goss = cfg.boosting_type == "goss"
        rf_sum = np.zeros((n, c))
        if is_rf and init_model is not None and init_model.trees:
            # seed the running sum with inherited trees so 1/T renormalization
            # counts them (bin mapper is shared by the warm-start adoption above)
            for i, tree in enumerate(self.trees):
                rf_sum[:, i % c] += tree.predict_binned(binned)

        # eval sets: (name, x, y[, group]) tuples; default = train set.
        # Raw eval scores are maintained incrementally (gbdt/goss) to avoid
        # re-predicting the whole forest each round.
        eval_state = []
        if eval_set or cfg.early_stopping_round > 0:
            sets = list(eval_set) if eval_set else [("train", x, y) +
                                                    ((group,) if is_rank else ())]
            for entry in sets:
                ex_raw = entry[1] if isinstance(entry[1], CSRMatrix) \
                    else np.asarray(entry[1], np.float64)
                name, ey = entry[0], np.asarray(entry[2], np.float64)
                eg = np.asarray(entry[3]) if len(entry) > 3 else None
                if init_model is not None and init_model.trees:
                    # _raw_scores encodes categoricals itself: feed raw rows
                    eraw = init_model._raw_scores(ex_raw).reshape(len(ex_raw), -1).copy()
                else:
                    eraw = np.tile(self.init_score.reshape(1, -1), (len(ex_raw), 1))
                # the default eval set IS the training data: reuse its binned
                # view instead of re-sorting the whole CSR
                ex = binned if ex_raw is x and sparse else self._prepare_x(ex_raw)
                eval_state.append((name, ex, ey, eg, eraw))

        best_metric = np.inf
        rounds_no_improve = 0
        bag_mask = np.ones(n)

        if delegate is not None:
            delegate.before_training(self)
        for it in range(cfg.num_iterations):
            # per-iteration rate: delegate override OR the config value —
            # cfg itself is never mutated (the override must not be sticky)
            cur_lr = cfg.learning_rate
            if delegate is not None:
                delegate.before_iteration(self, it)
                lr = delegate.get_learning_rate(self, it)
                if lr is not None:
                    cur_lr = float(lr)
            # --- dart: drop trees before computing gradients
            dropped: List[int] = []
            if is_dart and self.trees and rng.random() >= cfg.skip_drop:
                k = min(cfg.max_drop, max(1, int(round(cfg.drop_rate * len(self.trees)))))
                dropped = list(rng.choice(len(self.trees), size=min(k, len(self.trees)),
                                          replace=False))
                for t_idx in dropped:
                    tree = self.trees[t_idx]
                    scores[:, t_idx % c] -= self.tree_weights[t_idx] * \
                        tree.predict_binned(binned)

            raw = scores[:, 0] if c == 1 else scores
            if fobj is not None:
                grad, hess = fobj(raw, y, w)
            elif is_rank:
                grad, hess = lambdarank_grad(raw, y, w, group,
                                             sigmoid=cfg.sigmoid,
                                             truncation=cfg.max_position)
            else:
                grad, hess = self.objective.grad_fn(raw, y, w)
            grad = np.asarray(grad, np.float64).reshape(n, -1)
            hess = np.asarray(hess, np.float64).reshape(n, -1)

            # --- sampling: bagging (rf/gbdt) or goss
            if is_goss:
                g_abs = np.abs(grad).sum(axis=1)
                top_n = max(1, int(cfg.top_rate * n))
                other_n = max(1, int(cfg.other_rate * n))
                top_idx = np.argpartition(-g_abs, top_n - 1)[:top_n]
                rest = np.setdiff1d(np.arange(n), top_idx, assume_unique=False)
                other_idx = rng.choice(rest, size=min(other_n, len(rest)), replace=False)
                bag_mask = np.zeros(n)
                bag_mask[top_idx] = 1.0
                bag_mask[other_idx] = (1.0 - cfg.top_rate) / cfg.other_rate
            elif (is_rf or cfg.bagging_freq > 0) and cfg.bagging_fraction < 1.0:
                if is_rf or it % max(cfg.bagging_freq, 1) == 0:
                    bag_mask = (rng.random(n) < cfg.bagging_fraction).astype(np.float64)
            elif is_rf:
                bag_mask = (rng.random(n) < 0.632).astype(np.float64)

            trees_this_iter: List[Tree] = []
            for cls in range(c):
                tree = grower.grow(grad[:, cls], hess[:, cls], bag_mask, binned)
                trees_this_iter.append(tree)

            if is_dart and dropped:
                # normalize: new tree weighted 1/(k+1); dropped trees scaled k/(k+1)
                k = len(dropped)
                norm = k / (k + 1.0)
                new_w = cur_lr / (k + 1.0)
                for t_idx in dropped:
                    self.tree_weights[t_idx] *= norm
                    scores[:, t_idx % c] += self.tree_weights[t_idx] * \
                        self.trees[t_idx].predict_binned(binned)
                weight = new_w
            elif is_rf:
                weight = 1.0
            else:
                weight = cur_lr

            new_outputs = []
            for cls, tree in enumerate(trees_this_iter):
                self.trees.append(tree)
                self.tree_weights.append(weight)
                out = tree.predict_binned(binned)
                new_outputs.append(out)
                scores[:, cls] += weight * out

            if is_rf:
                # rf averages trees: keep the unweighted running sum so the
                # renormalization to 1/T is O(1) per iteration
                for cls, out in enumerate(new_outputs):
                    rf_sum[:, cls] += out
                t_per_class = len(self.trees) // c
                for i in range(len(self.trees)):
                    self.tree_weights[i] = 1.0 / t_per_class
                scores = np.tile(self.init_score.reshape(1, -1), (n, 1)) + \
                    rf_sum / t_per_class

            # --- eval + early stopping
            if eval_set or cfg.early_stopping_round > 0:
                metric_val = None
                incremental = not (is_rf or is_dart)  # those rescale old trees
                for name, ex, ey, eg, eraw in eval_state:
                    if incremental:
                        for cls, tree in enumerate(trees_this_iter):
                            eraw[:, cls] += weight * _tree_out(tree, ex)
                        raw_e = eraw
                    else:
                        # dart/rf rescale earlier trees: re-predict (ex is
                        # already categorical-encoded, so loop trees directly)
                        raw_e = np.tile(self.init_score.reshape(1, -1), (len(ex), 1))
                        for i, tree in enumerate(self.trees):
                            raw_e[:, i % c] += self.tree_weights[i] * _tree_out(tree, ex)
                    m, v = self._eval_metric_from_raw(raw_e, ey, eg)
                    self.eval_history.append(EvalRecord(it, name, m, v))
                    metric_val = v  # last eval set drives early stopping
                if cfg.early_stopping_round > 0 and metric_val is not None:
                    if metric_val < best_metric - 1e-12:
                        best_metric = metric_val
                        self.best_iteration = it
                        rounds_no_improve = 0
                    else:
                        rounds_no_improve += 1
                        if rounds_no_improve >= cfg.early_stopping_round:
                            break

            for cb in callbacks or []:
                cb(self, it)
            if delegate is not None:
                delegate.after_iteration(
                    self, it, [r for r in self.eval_history if r.iteration == it]
                )
                if delegate.should_stop(self, it):
                    break

        if delegate is not None:
            delegate.after_training(self)
        self._forest_cache = None
        return self

    def _eval_metric_from_raw(self, raw: np.ndarray, y: np.ndarray,
                              group: Optional[np.ndarray] = None) -> Tuple[str, float]:
        """Lower-is-better eval value for early stopping, from raw margins."""
        y = np.asarray(y, np.float64)
        if group is not None:
            # ranking: 1 - mean NDCG@max_position over query groups
            scores = raw[:, 0]
            trunc = self.config.max_position
            total, n_groups = 0.0, 0
            for g in np.unique(group):
                idx = np.where(group == g)[0]
                order = np.argsort(-scores[idx])
                gains = 2.0 ** y[idx][order] - 1
                k = min(trunc, len(idx))
                disc = 1.0 / np.log2(np.arange(len(idx)) + 2.0)
                ideal = np.sort(2.0 ** y[idx] - 1)[::-1]
                idcg = float((ideal[:k] * disc[:k]).sum())
                if idcg > 0:
                    total += float((gains[:k] * disc[:k]).sum()) / idcg
                n_groups += 1
            return "one_minus_ndcg", 1.0 - total / max(n_groups, 1)
        name = self.objective.name
        if name == "binary":
            p = np.clip(self.objective.transform(raw[:, 0]), 1e-12, 1 - 1e-12)
            return "binary_logloss", float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
        if name == "multiclass":
            pm = self.objective.transform(raw)
            p = np.clip(pm[np.arange(len(y)), y.astype(np.int64)], 1e-12, None)
            return "multi_logloss", float(-np.mean(np.log(p)))
        pred = self.objective.transform(raw[:, 0])
        return "l2", float(np.mean((pred - y) ** 2))

    # ---- persistence (saveNativeModel parity) --------------------------
    def model_string(self) -> str:
        return json.dumps({
            "config": {k: (list(v) if isinstance(v, (list, tuple)) else v)
                       for k, v in vars(self.config).items()},
            "bin_mapper": self.bin_mapper.to_dict() if self.bin_mapper else None,
            "init_score": self.init_score.tolist(),
            "tree_weights": self.tree_weights,
            "trees": [t.to_dict() for t in self.trees],
            "best_iteration": self.best_iteration,
        })

    @staticmethod
    def from_model_string(s: str) -> "Booster":
        d = json.loads(s)
        cfg = TrainConfig(**d["config"])
        md = d["bin_mapper"]
        mapper = None
        if md:
            mapper = (SparseBinMapper.from_dict(md) if md.get("kind") == "sparse"
                      else BinMapper.from_dict(md))
        b = Booster(cfg, mapper)
        b.init_score = np.asarray(d["init_score"], np.float64)
        b.tree_weights = list(d["tree_weights"])
        b.trees = [Tree.from_dict(t) for t in d["trees"]]
        b.best_iteration = d.get("best_iteration", -1)
        return b

    def save_native_model(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.model_string())

    @staticmethod
    def load_native_model(path: str) -> "Booster":
        with open(path) as f:
            return Booster.from_model_string(f.read())
