"""The port's automl (mmlspark_tpu_torch.automl: host copies over the
port's learners) and isolation forest (host tree build, scoring on the
device) held against the JAX package's on the same tables, on the CPU.

Tolerances: the spaces are the same host code, so their parameter maps
are equal.  The tuning picks the JAX package's winner and its trial
metrics are within 1e-6 (accuracy over the same folds: the two learners'
weights agree to about 1e-6, tests/test_torch_linear.py, and no
prediction on these tables sits within that of its decision boundary).
The forest's trees are equal array for array (the same numpy stream);
scores within 1e-6 (the f32 mean over the trees is summed in another
order), the fitted threshold within 1e-6 and the labels equal.
"""
import functools

import numpy as np
import pytest
import torch

from mmlspark_tpu import Table as JTable
from mmlspark_tpu import automl as JA
from mmlspark_tpu.isolationforest import IsolationForest as JIF
from mmlspark_tpu.models.linear import LogisticRegression as JLR

from mmlspark_tpu_torch import Table as PTable
from mmlspark_tpu_torch import automl as PA
from mmlspark_tpu_torch.isolationforest import IsolationForest as PIF
from mmlspark_tpu_torch.isolationforest import iforest as PI
from mmlspark_tpu_torch.models.linear import LogisticRegression as PLR

torch.set_num_threads(2)

CPU = {"device": "cpu"}


def _cls_cols(n=150, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(np.int64)
    return {"features": x, "label": y}


def _space(pkg):
    return (pkg.HyperparamBuilder()
            .add_hyperparam("reg_param", pkg.DiscreteHyperParam([1e-4, 10.0]))
            .add_hyperparam("max_iter", pkg.DiscreteHyperParam([2, 60]))
            .build())


def test_grid_and_random_spaces_equal_the_reference():
    jg = list(JA.GridSpace(_space(JA)).param_maps())
    pg = list(PA.GridSpace(_space(PA)).param_maps())
    assert pg == jg and len(pg) == 4

    def rand(pkg):
        space = (pkg.HyperparamBuilder()
                 .add_hyperparam("lr", pkg.LogRangeHyperParam(1e-4, 1.0))
                 .add_hyperparam("steps", pkg.IntRangeHyperParam(10, 100))
                 .add_hyperparam("frac", pkg.FloatRangeHyperParam(0.1, 0.9))
                 .add_hyperparam("kind", pkg.DiscreteHyperParam(["a", "b"]))
                 .build())
        return list(pkg.RandomSpace(space, num_samples=15, seed=4)
                    .param_maps())

    assert rand(PA) == rand(JA)


@functools.lru_cache(maxsize=None)
def _tuned():
    cols = _cls_cols()
    jm = JA.TuneHyperparameters(
        models=[JLR()], param_space=JA.GridSpace(_space(JA)),
        evaluation_metric="accuracy", num_folds=3, parallelism=1,
        seed=2).fit(JTable(dict(cols)))
    pm = PA.TuneHyperparameters(
        models=[PLR(**CPU)], param_space=PA.GridSpace(_space(PA)),
        evaluation_metric="accuracy", num_folds=3, parallelism=3,
        seed=2).fit(PTable(dict(cols)))
    return jm, pm, cols


def test_tune_hyperparameters_picks_the_jax_winner():
    jm, pm, cols = _tuned()
    assert [t["params"] for t in pm.all_metrics] == \
        [t["params"] for t in jm.all_metrics]
    np.testing.assert_allclose([t["metric"] for t in pm.all_metrics],
                               [t["metric"] for t in jm.all_metrics],
                               atol=1e-6)
    assert pm.best_metric == pytest.approx(jm.best_metric, abs=1e-6)
    scale = float(np.abs(jm.best_model.weights["w"]).max())
    np.testing.assert_allclose(pm.best_model.weights["w"],
                               jm.best_model.weights["w"], atol=1e-4 * scale)
    pj = np.asarray(jm.transform(JTable(dict(cols)))["prediction"])
    pp = np.asarray(pm.transform(PTable(dict(cols)))["prediction"])
    np.testing.assert_array_equal(pp, pj)


def test_find_best_model_picks_the_jax_winner():
    cols = _cls_cols(seed=3)
    jt, pt = JTable(dict(cols)), PTable(dict(cols))
    # (weights of 1e-6, as the reference's fuzz example fits, would tie
    # the scores within f32 rounding and make AUC a coin toss)
    jms = [JLR(max_iter=1, learning_rate=1e-2).fit(jt),
           JLR(max_iter=60).fit(jt), JLR(max_iter=5).fit(jt)]
    pms = [PLR(max_iter=1, learning_rate=1e-2, **CPU).fit(pt),
           PLR(max_iter=60, **CPU).fit(pt), PLR(max_iter=5, **CPU).fit(pt)]
    for metric in ("accuracy", "AUC"):
        jb = JA.FindBestModel(models=jms, evaluation_metric=metric).fit(jt)
        pb = PA.FindBestModel(models=pms, evaluation_metric=metric).fit(pt)
        assert pms.index(pb.best_model) == jms.index(jb.best_model)
        assert pb.best_model_metrics["metric"] == metric
        np.testing.assert_allclose(
            [m["value"] for m in pb.all_model_metrics],
            [m["value"] for m in jb.all_model_metrics], atol=1e-6)
        assert [m["estimator"] for m in pb.all_model_metrics] == \
            [m["estimator"] for m in jb.all_model_metrics]


def test_nan_metrics_never_win():
    from mmlspark_tpu_torch.automl.tune import _select_best

    assert _select_best([np.nan, 0.4, 0.9], True) == 2
    assert _select_best([np.nan, 0.4, 0.9], False) == 1
    with pytest.raises(ValueError):
        _select_best([np.nan, np.nan], True)


def _outlier_cols(seed=0, n=300, d=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:10] += 6.0
    return {"features": x}


@functools.lru_cache(maxsize=None)
def _forests(contamination, bootstrap=False, max_features=1.0):
    cols = _outlier_cols()
    kw = dict(num_estimators=25, max_samples=64, contamination=contamination,
              bootstrap=bootstrap, max_features=max_features, seed=5)
    return (JIF(**kw).fit(JTable(dict(cols))),
            PIF(**kw, **CPU).fit(PTable(dict(cols))), cols)


@pytest.mark.parametrize("case", [(0.0, False, 1.0), (0.05, False, 1.0),
                                  (0.05, True, 0.6)])
def test_isolation_forest_trees_scores_and_threshold(case):
    jm, pm, cols = _forests(*case)
    assert len(pm.trees) == len(jm.trees) == 6
    for a, b in zip(pm.trees, jm.trees):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert pm.max_depth == jm.max_depth
    assert pm.subsample_size == jm.subsample_size
    assert pm.threshold == pytest.approx(jm.threshold, abs=1e-6)
    oj = jm.transform(JTable(dict(cols)))
    op = pm.transform(PTable(dict(cols)))
    sj, sp = np.asarray(oj["outlier_score"]), np.asarray(op["outlier_score"])
    assert sp.dtype == sj.dtype == np.float64
    np.testing.assert_allclose(sp, sj, atol=1e-6, rtol=0)
    near = np.abs(sj - jm.threshold) < 1e-6
    np.testing.assert_array_equal(np.asarray(op["predicted_label"])[~near],
                                  np.asarray(oj["predicted_label"])[~near])
    if case[0] == 0.0:  # score-only mode labels nothing
        assert pm.threshold == 2.0
        assert not np.asarray(op["predicted_label"]).any()
    else:
        assert np.asarray(op["predicted_label"])[:10].mean() >= 0.8


def test_isolation_forest_chunks_and_empty_tables(monkeypatch):
    jm, pm, cols = _forests(0.05)
    want = pm._scores(cols["features"])
    monkeypatch.setattr(PI, "_ROWS", 7)
    np.testing.assert_array_equal(pm._scores(cols["features"]), want)
    out = pm.transform(PTable({"features": np.zeros((0, 5), np.float32)}))
    assert len(out["outlier_score"]) == 0
