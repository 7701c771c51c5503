"""The port's GBDT engine (mmlspark_tpu_torch.gbdt) held against the JAX
package's on the CPU.

The same numpy inputs, made from seeds (the reference's own data recipes
of tests/test_gbdt.py), go through both: the binning exactly; histograms
at the reference's 1e-4 (tests/test_gbdt.py:90); the split search's
feature and threshold exactly, its gain at rtol 1e-5 and its stats
within 1e-5 of the node's absolute mass; the
forest predictor at 1e-4 (test_gbdt.py:334); one booster per boosting
type and per objective family with every tree equal, by the tie rule of
tests/torch_gbdt_compare.py, and scores at 1e-4; model strings read
across both packages with equal scores; the estimators through Tables.
The JAX side trains unsharded (`mesh=None` / `parallelism="serial"`):
the repo conftest gives JAX eight CPU devices, on which the estimators'
default would shard.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.core.schema import Table as JTable
from mmlspark_tpu.gbdt import (Booster as JBooster, GBDTClassifier as JCls,
                               GBDTRanker as JRanker,
                               GBDTRegressor as JReg, TrainConfig as JConfig)
from mmlspark_tpu.gbdt import binning as JBin
from mmlspark_tpu.gbdt import histogram as JH
from mmlspark_tpu.gbdt import tree as JT
from mmlspark_tpu.gbdt.delegate import LearningRateSchedule as JSchedule
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.core import registry
from mmlspark_tpu_torch.gbdt import (Booster, GBDTClassifier, GBDTRanker,
                                     GBDTRegressor, LightGBMClassifier,
                                     TrainConfig)
from mmlspark_tpu_torch.gbdt import binning as PBin
from mmlspark_tpu_torch.gbdt import histogram as PH
from mmlspark_tpu_torch.gbdt import tree as PT
from mmlspark_tpu_torch.gbdt.delegate import LearningRateSchedule

from torch_gbdt_compare import (TOL, compare_fits, following_splits,
                                recorded_splits)

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _binary_data(n=600, d=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    logits = x[:, 0] * 2 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    y = (logits + rng.normal(scale=0.5, size=n) > 0).astype(np.float64)
    return x, y


def _regression_data(n=600, d=8, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = 3 * x[:, 0] + np.sin(2 * x[:, 1]) + 0.5 * x[:, 2] * x[:, 3] + \
        0.1 * rng.normal(size=n)
    return x, y


def _multiclass_data(n=450, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6))
    y = ((x[:, 0] > 0).astype(int) + (x[:, 1] > 0.5).astype(int)).astype(
        np.float64)
    return x, y


def _rank_data(n_groups=30, per=10, seed=11):
    rng = np.random.default_rng(seed)
    n = n_groups * per
    x = rng.normal(size=(n, 5))
    rel = np.clip((x[:, 0] + 0.3 * rng.normal(size=n)) * 2 + 2, 0, 4).round()
    return x, rel, np.repeat(np.arange(n_groups), per)


# ---- binning -----------------------------------------------------------

@pytest.mark.parametrize("max_bin,cats", [(63, []), (255, []), (15, [2])])
def test_bin_mapper_codes_and_boundaries_equal_the_jax_package(max_bin, cats):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(700, 4))
    x[::13, 1] = np.nan
    x[:, 2] = rng.integers(0, 6, size=700)
    x[:, 3] = np.round(x[:, 3], 1)          # few distinct values
    j = JBin.BinMapper(max_bin, categorical_features=cats, sample_count=500)
    p = PBin.BinMapper(max_bin, categorical_features=cats, sample_count=500)
    np.testing.assert_array_equal(p.fit_transform(x), j.fit_transform(x))
    for a, b in zip(p.boundaries_, j.boundaries_):
        np.testing.assert_array_equal(a, b)
    assert p.categories_ == j.categories_
    assert p.to_dict() == j.to_dict()
    assert PBin.MISSING_BIN == 0 and p.num_bins == max_bin + 1
    for f in range(4):
        for b in (0, 1, max_bin // 2, max_bin):
            assert p.bin_upper_value(f, b) == j.bin_upper_value(f, b)


# ---- histogram and split search ----------------------------------------

def _node(n, f, b, seed, mask_share=0.7):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    w = (rng.random(n) < 0.9).astype(np.float32)
    mask = rng.random(n) < mask_share
    return binned, grad, hess, w, mask


def _jax_hist(binned, grad, hess, w, mask, b):
    return JH.build_histogram(jnp.asarray(binned), jnp.asarray(grad),
                              jnp.asarray(hess), jnp.asarray(w),
                              jnp.asarray(mask), b)


def _port_hist(binned, grad, hess, w, mask, b):
    t = functools.partial(torch.as_tensor, device=CPU)
    return PH.build_histogram(t(binned), t(grad), t(hess), t(w), t(mask), b)


@pytest.mark.parametrize("n,f,b", [(200, 5, 16), (1000, 28, 256),
                                   (64, 300, 4)])
def test_build_histogram_matches_the_jax_package(n, f, b):
    args = _node(n, f, b, seed=n + f)
    want = np.asarray(_jax_hist(*args, b))
    got = _port_hist(*args, b)
    assert got.shape == (f, b, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the sibling by subtraction
    parent = _port_hist(*args[:4], np.ones(n, bool), b)
    np.testing.assert_allclose(
        PH.subtract_histogram(parent, got).numpy(),
        np.asarray(JH.subtract_histogram(
            _jax_hist(*args[:4], np.ones(n, bool), b), want)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("l1,l2,min_data", [(0.0, 0.0, 20), (0.5, 1.0, 5)])
def test_best_split_matches_the_jax_package(seed, l1, l2, min_data):
    b = 32
    binned, grad, hess, w, mask = _node(500, 7, b, seed=seed)
    grad = (grad + 0.8 * (binned[:, seed % 7] > b // 2)).astype(np.float32)
    fmask = np.random.default_rng(seed).random(7) < 0.8
    fmask[seed % 7] = True
    args = (l1, l2, min_data, 1e-3, 0.0, fmask)
    want = JH.best_split(_jax_hist(binned, grad, hess, w, mask, b), *args)
    got = PH.best_split(_port_hist(binned, grad, hess, w, mask, b), *args)
    assert want is not None and got is not None
    assert (got.feature, got.bin_threshold) == (want.feature,
                                                 want.bin_threshold)
    np.testing.assert_allclose(got.gain, want.gain, rtol=1e-5)
    # each stat within 1e-5 of the node's absolute mass of its channel: a
    # gradient sum can cancel to ~0, where JAX's f32 sum keeps its
    # rounding (the port accumulates in f64)
    live = w * mask
    mass = np.array([np.abs(grad * live).sum(), np.abs(hess * live).sum(),
                     live.sum()] * 2)
    np.testing.assert_allclose(np.asarray(got[3:]) / mass,
                               np.asarray(want[3:]) / mass, rtol=0,
                               atol=1e-5)


def test_best_split_with_no_valid_split_is_none():
    """Every score -inf (min_data_in_leaf above the node's rows): both
    engines' argmax lands on index 0 and both return None."""
    binned, grad, hess, w, mask = _node(50, 4, 8, seed=3, mask_share=1.0)
    hist = _port_hist(binned, grad, hess, w, mask, 8)
    scores = PH._split_scores(hist, 0.0, 0.0, 1000, 1e-3)
    assert torch.isinf(scores).all()
    idx, out = PH._split_summary(hist, torch.ones(4, dtype=torch.bool), 0.0,
                                 0.0, 1000, 1e-3)
    assert idx.dtype == torch.int32 and int(idx) == 0 and out.shape == (7,)
    assert PH.best_split(hist, 0.0, 0.0, 1000, 1e-3, 0.0) is None
    assert JH.best_split(_jax_hist(binned, grad, hess, w, mask, 8), 0.0, 0.0,
                         1000, 1e-3, 0.0) is None
    # a feature mask with nothing left: None too
    assert PH.best_split(hist, 0.0, 0.0, 5, 1e-3, 0.0,
                         np.zeros(4, bool)) is None


def test_split_summary_large_flat_index_stays_exact():
    """F·B above 2^24: the int32 index rides the 32-byte copy bit-exact."""
    f, b = 70_000, 256
    hist = torch.zeros(f, b, 3)
    hist[:, :, 1] = 1.0
    hist[:, :, 2] = 10.0
    hist[f - 1, : b // 2, 0] = -5.0
    hist[f - 1, b // 2:, 0] = 5.0
    s = PH.best_split(hist, 0.0, 0.0, 1, 1e-3, 0.0)
    assert s is not None and (s.feature, s.bin_threshold) == (f - 1,
                                                              b // 2 - 1)
    assert s.left_count == 10.0 * b // 2 and s.left_grad == -5.0 * b // 2


def test_vote_features_matches_the_jax_package():
    rng = np.random.default_rng(4)
    local = np.stack([_port_hist(*_node(300, 12, 16, seed=s), 16).numpy()
                      for s in range(3)])
    local[1, :, :, 0] += rng.normal(size=(12, 16)).astype(np.float32)
    for k in (1, 3, 20):
        np.testing.assert_array_equal(
            PH.vote_features(local, 0.0, 1.0, 5, 1e-3, k),
            JH.vote_features(local, 0.0, 1.0, 5, 1e-3, k))


def test_builder_casts_f64_gradients_to_f32_before_upload():
    binned, grad, hess, w, mask = _node(100, 3, 8, seed=5)
    builder = PH.HistogramBuilder(binned, 8, device="cpu")
    g64 = grad.astype(np.float64) + 1e-12
    arrs = builder.device_arrays(g64, hess.astype(np.float64), w)
    assert all(a.dtype == torch.float32 for a in arrs)
    np.testing.assert_array_equal(arrs[0].numpy(), g64.astype(np.float32))
    hist = builder.build(*arrs, builder.node_mask(mask))
    np.testing.assert_array_equal(hist.numpy(),
                                  _port_hist(binned, g64.astype(np.float32),
                                             hess, w, mask, 8).numpy())
    assert builder.build_local(*arrs, builder.node_mask(mask)).shape == \
        (1, 3, 8, 3)


# ---- forest prediction -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_regressor():
    x, y = _regression_data(n=250)
    cfg = JConfig(num_iterations=8, num_leaves=15, min_data_in_leaf=5)
    return JBooster(cfg).fit(x, y)


def test_predict_forest_matches_the_jax_package():
    j = _jax_regressor()
    b = Booster.from_model_string(j.model_string())
    x, _ = _regression_data(n=300, seed=9)
    x[::7, 2] = np.nan                       # NaN goes left
    arrs = PT.tree_arrays_for_jit(b.trees)
    jarrs = JT.tree_arrays_for_jit(j.trees)
    for k in arrs:
        np.testing.assert_array_equal(arrs[k], jarrs[k])
    assert arrs["threshold_value"].dtype == np.float32
    md = max(t.max_depth for t in b.trees)
    w = np.asarray(b.tree_weights, np.float32)
    got = PT.predict_forest({k: torch.as_tensor(v) for k, v in arrs.items()},
                            torch.as_tensor(x.astype(np.float32)),
                            torch.as_tensor(w), md)
    want = JT.predict_forest(jarrs, jnp.asarray(x, jnp.float32),
                             jnp.asarray(w), md)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(b.raw_scores_jit(x, device="cpu"),
                               b._raw_scores(x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b.raw_scores_jit(x, device="cpu"),
                               j.raw_scores_jit(x), rtol=1e-4, atol=1e-4)


# ---- boosters: one per boosting type and objective family ---------------

BOOSTERS = {
    "gbdt": ("binary", {}),
    "rf": ("binary", {"boosting_type": "rf", "bagging_fraction": 0.8}),
    "dart": ("binary", {"boosting_type": "dart"}),
    "goss": ("binary", {"boosting_type": "goss"}),
    "multiclass": ("multiclass", {"objective": "multiclass", "num_class": 3}),
    "regression": ("regression", {"objective": "regression"}),
    "lambdarank": ("rank", {"objective": "regression", "num_leaves": 7,
                            "min_data_in_leaf": 3, "max_position": 10}),
}


def _case_data(kind):
    if kind == "binary":
        return _binary_data() + (None,)
    if kind == "multiclass":
        return _multiclass_data() + (None,)
    if kind == "regression":
        return _regression_data() + (None,)
    return _rank_data()


def _config(name):
    kind, over = BOOSTERS[name]
    kw = dict(objective="binary", num_iterations=10, num_leaves=15,
              min_data_in_leaf=5, seed=0)
    kw.update(over)
    return kind, kw


@functools.lru_cache(maxsize=None)
def _jax_fit(name):
    kind, kw = _config(name)
    x, y, group = _case_data(kind)
    with recorded_splits(JT) as calls:
        booster = JBooster(JConfig(**kw)).fit(x, y, group=group)
    return booster, calls


@functools.lru_cache(maxsize=None)
def _port_fit(name):
    kind, kw = _config(name)
    x, y, group = _case_data(kind)
    j, jcalls = _jax_fit(name)
    with following_splits(PT, jcalls, name,
                          j.trees if name == "goss" else None) as (_, ties):
        booster = Booster(TrainConfig(**kw)).fit(x, y, group=group,
                                                 device="cpu")
    return booster, ties


@pytest.mark.parametrize("name", sorted(BOOSTERS))
def test_booster_trees_and_scores_match_the_jax_package(name):
    j, _ = _jax_fit(name)
    p, _ = _port_fit(name)
    compare_fits(j, p, label=name)
    assert len(p.trees) == 10 * (3 if name == "multiclass" else 1)
    x = _case_data(BOOSTERS[name][0])[0]
    np.testing.assert_allclose(p._raw_scores(x), j._raw_scores(x), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(p.score(x), j.score(x), rtol=TOL, atol=TOL)


def test_model_strings_read_across_both_packages():
    """The weight bridge: a JAX-trained forest scored by the port and a
    port-trained one by JAX give equal scores."""
    x, _ = _binary_data(n=200, seed=3)
    for name, xs in (("gbdt", x), ("multiclass", x[:, :6]),
                     ("lambdarank", x[:, :5])):
        j, _ = _jax_fit(name)
        p, _ = _port_fit(name)
        from_jax = Booster.from_model_string(j.model_string())
        np.testing.assert_array_equal(from_jax._raw_scores(xs),
                                      j._raw_scores(xs))
        assert from_jax.model_string() == j.model_string()
        to_jax = JBooster.from_model_string(p.model_string())
        np.testing.assert_array_equal(to_jax.score(xs), p.score(xs))
    j, _ = _jax_fit("gbdt")
    b = Booster.from_model_string(j.model_string())
    np.testing.assert_allclose(b.raw_scores_jit(x, device="cpu"),
                               np.asarray(j.raw_scores_jit(x)), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(b.predict_leaf(x), j.predict_leaf(x))
    np.testing.assert_array_equal(b.feature_importances("gain"),
                                  j.feature_importances("gain"))
    np.testing.assert_array_equal(b.features_shap(x[:20]),
                                  j.features_shap(x[:20]))


def test_early_stopping_and_a_delegate_match_the_jax_package():
    x, y = _binary_data()
    xv, yv = _binary_data(n=300, seed=5)
    kw = dict(objective="binary", num_iterations=40, num_leaves=15,
              min_data_in_leaf=5, early_stopping_round=3)
    sched = lambda i: 0.3 / (1 + i)  # noqa: E731
    with recorded_splits(JT) as jcalls:
        j = JBooster(JConfig(**kw)).fit(x, y, eval_set=[("valid", xv, yv)],
                                        delegate=JSchedule(sched))
    with following_splits(PT, jcalls, "early stopping"):
        p = Booster(TrainConfig(**kw)).fit(
            x, y, eval_set=[("valid", xv, yv)],
            delegate=LearningRateSchedule(sched), device="cpu")
    compare_fits(j, p, label="early stopping")
    assert p.best_iteration == j.best_iteration
    assert len(p.trees) == len(j.trees)
    np.testing.assert_allclose([r.value for r in p.eval_history],
                               [r.value for r in j.eval_history], rtol=1e-4)
    np.testing.assert_allclose(p._raw_scores(xv), j._raw_scores(xv),
                               rtol=TOL, atol=TOL)


def test_warm_start_matches_the_jax_package():
    x, y = _regression_data(n=300)
    kw = dict(num_iterations=4, num_leaves=7, min_data_in_leaf=5)
    j0 = JBooster(JConfig(**kw)).fit(x[:150], y[:150])
    p0 = Booster.from_model_string(j0.model_string())
    with recorded_splits(JT) as jcalls:
        j = JBooster(JConfig(**kw)).fit(x[150:], y[150:], init_model=j0)
    with following_splits(PT, jcalls, "warm start"):
        p = Booster(TrainConfig(**kw)).fit(x[150:], y[150:], init_model=p0,
                                           device="cpu")
    compare_fits(j, p, label="warm start")
    assert len(p.trees) == len(j.trees) == 8
    np.testing.assert_allclose(p._raw_scores(x), j._raw_scores(x), rtol=TOL,
                               atol=TOL)


def test_a_mesh_raises_and_the_default_device_is_the_card():
    """A world-1 gloo mesh fit (data- and voting-parallel) equals the
    serial fit: the all-reduce of one rank is the identity, and voting
    over every feature keeps them all."""
    from torch_world1 import world1_gloo

    x, y = _binary_data(n=100)
    kw = dict(objective="binary", num_iterations=3, num_leaves=4,
              min_data_in_leaf=5)
    serial = Booster(TrainConfig(**kw)).fit(x, y, device="cpu")
    with world1_gloo() as mesh:
        for par in ("data_parallel", "voting_parallel"):
            meshed = Booster(TrainConfig(parallelism=par, top_k=x.shape[1],
                                         **kw)).fit(x, y, mesh=mesh,
                                                    device="cpu")
            compare_fits(serial, meshed, label=f"world-1 {par}")
            np.testing.assert_array_equal(meshed._raw_scores(x),
                                          serial._raw_scores(x))
        b = PH.HistogramBuilder(np.zeros((4, 2), np.uint8), 4, mesh=mesh,
                                device="cpu")
        assert b.build_local(*b.device_arrays(np.ones(4), np.ones(4),
                                              np.ones(4)),
                             b.node_mask(np.ones(4, bool))).shape == (1, 2, 4, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Booster(TrainConfig(objective="binary",
                                num_iterations=1)).fit(x, y)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GBDTClassifier(num_iterations=1).fit(
                Table({"features": x, "label": y}))
        b = Booster(TrainConfig(objective="binary", num_iterations=2)).fit(
            x, y, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Booster.from_model_string(b.model_string()).raw_scores_jit(x)
        assert b.raw_scores_jit(x).shape == (100,)   # fit's device kept


# ---- estimators through Tables -----------------------------------------

def _est_case(name):
    if name == "classifier":
        x, y = _binary_data(n=300)
        kw = dict(num_iterations=8, num_leaves=15, min_data_in_leaf=5,
                  is_unbalance=True)
        return JCls, GBDTClassifier, {"features": x, "label": y}, kw
    if name == "multiclass":
        x, y = _multiclass_data(n=300)
        kw = dict(num_iterations=5, num_leaves=7, min_data_in_leaf=5)
        return JCls, GBDTClassifier, {"features": x, "label": y}, kw
    if name == "regressor":
        x, y = _regression_data(n=300)
        w = np.random.default_rng(2).uniform(0.5, 2.0, size=300)
        valid = np.arange(300) % 5 == 0
        kw = dict(num_iterations=8, num_leaves=15, min_data_in_leaf=5,
                  objective="huber", weight_col="w",
                  validation_indicator_col="v", num_batches=2)
        return JReg, GBDTRegressor, {"features": x, "label": y, "w": w,
                                     "v": valid}, kw
    x, rel, group = _rank_data(n_groups=12, per=8)
    kw = dict(num_iterations=5, num_leaves=7, min_data_in_leaf=3)
    return JRanker, GBDTRanker, {"features": x, "label": rel,
                                 "group": group}, kw


@pytest.mark.parametrize("name", ["classifier", "multiclass", "regressor",
                                  "ranker"])
def test_estimators_match_the_jax_package(name):
    jcls, pcls, cols, kw = _est_case(name)
    with recorded_splits(JT) as jcalls:
        jm = jcls(parallelism="serial", **kw).fit(JTable(dict(cols)))
    with following_splits(PT, jcalls, name):
        pm = pcls(device="cpu", **kw).fit(Table(dict(cols)))
    compare_fits(jm.booster, pm.booster, label=name)
    jo, po = jm.transform(JTable(dict(cols))), pm.transform(Table(dict(cols)))
    assert po.column_names == jo.column_names
    for c in po.column_names:
        a, b = np.asarray(po[c]), np.asarray(jo[c])
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=c)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)
    assert pm.get_feature_importances() == jm.get_feature_importances()


def test_lightgbm_aliases_are_registered_under_both_names():
    stages = registry.all_stages()
    for a, b in (("LightGBMClassifier", "GBDTClassifier"),
                 ("LightGBMRegressor", "GBDTRegressor"),
                 ("LightGBMRanker", "GBDTRanker")):
        assert stages[a] is stages[b]
    assert LightGBMClassifier is GBDTClassifier
    assert GBDTClassifier().device is None      # None resolves to the card
