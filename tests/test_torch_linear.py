"""The port's linear learners (mmlspark_tpu_torch.models.linear) and
TrainClassifier / TrainRegressor (models/train_classifier.py) held
against the JAX package's on the same tables, made from seeds with numpy,
on the CPU (`device="cpu"`; the default is the card, and without one it
raises).

Tolerances, from the spread measured between the two packages on the
CPU (the port's f32 Adam is torch.optim.Adam, the JAX package's
optax.adam: the same arithmetic, rounded in another order):
- `LogisticRegression` on standardized features (40 to 200 steps):
  weights within 1e-4 of max |w| (measured at most 3.7e-6 on these
  tables), scores within 1e-5 (measured 1.3e-6), predictions equal where
  the JAX model's two top probabilities are 1e-3 or more apart.  Adam's
  step is scale-free, so rounding noise in a near-zero gradient becomes a
  step of up to lr: weights part more than scores do.
- the same weights through both packages' `transform` (no fit): scores
  within 1e-6, predictions equal away from a tie (1e-6).
- `TrainClassifier` on standardized mixed columns as the first item; over
  raw columns (one near 1e5, as Adult's fnlwgt) weights within 1e-2 of
  max |w| (measured 6.9e-6 here, and 5.8e-3 after one step on a
  4,000-row Adult-shaped table, where Adam's first step is the
  gradient's sign), scores within 5e-2 (measured 2.4e-4), predictions
  equal where the JAX model's two top probabilities are 0.1 or more
  apart.
- `LinearRegression` (f64): weights within 1e-9 of max |w| on a full-rank
  table (measured 3.9e-16); `TrainRegressor` over one-hot columns, whose
  block sums to the intercept (a null space the 1e-6 ridge alone pins),
  weights within 1e-4 of max |w| (measured 1.4e-8 here, 9.6e-6 on a
  50,000-row flights table) and predictions within 1e-9 of max
  |prediction| (measured 4.3e-16).
"""
import contextlib
import functools
import os
import threading

import numpy as np
import pytest
import torch

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.models import linear as JL
from mmlspark_tpu.models import train_classifier as JTC

from mmlspark_tpu_torch import PipelineStage, Table as PTable
from mmlspark_tpu_torch.models import linear as PL
from mmlspark_tpu_torch.models import train_classifier as PTC

from torch_tables import assert_same_table

torch.set_num_threads(2)

CPU = {"device": "cpu"}


def cls_cols(n=300, d=6, classes=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    logits = x[:, :classes] * 2.0 + 0.5 * rng.normal(size=(n, classes))
    return {"features": x, "label": logits.argmax(1).astype(np.float64)}


def reg_cols(n=200, d=5, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = x @ rng.normal(size=d) + 0.3 + 0.05 * rng.normal(size=n)
    return {"features": x, "label": y}


def mixed_cols(n=200, seed=2, raw=False):
    """Numeric, categorical and text columns with a string label; `raw`
    gives Adult-like scales (a column near 1e5)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    b = rng.normal(size=n) * (1e5 if raw else 1.0) + (2e5 if raw else 0.0)
    cat = rng.choice(["red", "green", "blue"], n)
    word = rng.choice(["alpha beta", "beta", "gamma delta beta"], n)
    score = a + (cat == "red") - 0.5 * (cat == "blue") + 0.3 * rng.normal(
        size=n)
    label = np.where(score > 0.8, "high", np.where(score < -0.5, "low",
                                                   "mid"))
    return {"a": a, "b": b, "cat": cat, "word": np.asarray(word, object),
            "label": np.asarray(label, object)}


def close_weights(jw, pw, rtol):
    for k in ("w", "b"):
        assert pw[k].shape == jw[k].shape and pw[k].dtype == jw[k].dtype, k
    scale = np.abs(jw["w"]).max()
    err = max(np.abs(jw[k] - pw[k]).max() for k in ("w", "b")) / scale
    assert err <= rtol, f"weights {err} of max |w| > {rtol}"


def close_scores(js, ps, atol, margin):
    """Scores within atol; the same predictions where the JAX model's two
    top probabilities are `margin` or more apart."""
    assert ps.dtype == js.dtype == np.float32 and ps.shape == js.shape
    np.testing.assert_allclose(ps, js, rtol=0, atol=atol)
    top2 = np.sort(js, axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] >= margin
    np.testing.assert_array_equal(ps.argmax(1)[sure], js.argmax(1)[sure])


# ---- LogisticRegression ---------------------------------------------------

LR_CASES = {"binary-60": (dict(), 60), "binary-200": (dict(), 200),
            "3-class-60": (dict(classes=3, d=8, seed=3), 60),
            "4-class-reg": (dict(classes=4, d=10, seed=4), 40)}


@functools.lru_cache(maxsize=None)
def jax_lr(case):
    kw, steps = LR_CASES[case]
    extra = {"reg_param": 1e-2} if case == "4-class-reg" else {}
    return JL.LogisticRegression(max_iter=steps, **extra).fit(
        JTable(cls_cols(**kw)))


@pytest.mark.parametrize("case", sorted(LR_CASES))
def test_logistic_regression_fit_equals_the_jax_package(case):
    kw, steps = LR_CASES[case]
    extra = {"reg_param": 1e-2} if case == "4-class-reg" else {}
    jm = jax_lr(case)
    pm = PL.LogisticRegression(max_iter=steps, **extra, **CPU).fit(
        PTable(cls_cols(**kw)))
    assert pm.num_classes == jm.num_classes
    close_weights(jm.weights, pm.weights, 1e-4)
    probe = cls_cols(n=200, seed=99, **{k: v for k, v in kw.items()
                                        if k != "seed"})
    js = jm.transform(JTable(dict(probe)))
    ps = pm.transform(PTable(dict(probe)))
    assert ps["prediction"].dtype == np.float64
    close_scores(js["scores"], ps["scores"], 1e-5, 1e-3)


@pytest.mark.parametrize("case", sorted(LR_CASES))
def test_logistic_transform_on_carried_weights(case):
    """A JAX model's weights build the port's model as they are: the
    transform alone, apart from the fit."""
    kw, _ = LR_CASES[case]
    jm = jax_lr(case)
    pm = PL.LogisticRegressionModel(weights=jm.weights, **CPU)
    probe = cls_cols(n=150, seed=7, **{k: v for k, v in kw.items()
                                       if k != "seed"})
    js = jm.transform(JTable(dict(probe)))
    ps = pm.transform(PTable(dict(probe)))
    close_scores(js["scores"], ps["scores"], 1e-6, 1e-6)
    assert ps.column_names == js.column_names


def test_logistic_regression_takes_a_ragged_features_column():
    cols = cls_cols(n=60)
    rows = np.empty(60, object)
    for i in range(60):
        rows[i] = cols["features"][i].astype(np.float64)
    pm = PL.LogisticRegression(max_iter=20, **CPU).fit(
        PTable({"features": rows, "label": cols["label"]}))
    dense = PL.LogisticRegression(max_iter=20, **CPU).fit(PTable(cols))
    for k in ("w", "b"):
        np.testing.assert_array_equal(pm.weights[k], dense.weights[k])


def test_the_loss_and_steps_are_the_reference_arithmetic():
    """`fit_logistic` (f32) against a hand-written optax.adam update of
    the same loss in f64: five steps within 1e-5."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(50, 4)))
    y = torch.as_tensor(rng.integers(0, 3, 50))
    w = np.zeros((4, 3))
    b = np.zeros(3)
    m = [np.zeros_like(w), np.zeros_like(b)]
    v = [np.zeros_like(w), np.zeros_like(b)]
    reg, lr = 0.05, 0.1
    xn, yn = x.numpy(), y.numpy()
    for t in range(1, 6):
        logits = xn @ w + b
        p = np.exp(logits - logits.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        p[np.arange(50), yn] -= 1.0
        grads = [xn.T @ p / 50 + 2 * reg * w, p.mean(0)]
        for i, (param, g) in enumerate(zip((w, b), grads)):
            m[i] = 0.9 * m[i] + 0.1 * g
            v[i] = 0.999 * v[i] + 0.001 * g * g
            mhat, vhat = m[i] / (1 - 0.9 ** t), v[i] / (1 - 0.999 ** t)
            param -= lr * mhat / (np.sqrt(vhat) + 1e-8)
    pw, pb, _ = PL.fit_logistic(x.float(), y.long(), 3, reg, 5, lr)
    np.testing.assert_allclose(pw.numpy(), w, atol=1e-5)
    np.testing.assert_allclose(pb.numpy(), b, atol=1e-5)


# ---- LinearRegression -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_ridge(reg):
    return JL.LinearRegression(reg_param=reg).fit(JTable(reg_cols()))


@pytest.mark.parametrize("reg", [1e-6, 1.0])
def test_linear_regression_fit_equals_the_jax_package(reg):
    jm = jax_ridge(reg)
    pm = PL.LinearRegression(reg_param=reg, **CPU).fit(PTable(reg_cols()))
    close_weights(jm.weights, pm.weights, 1e-9)
    assert pm.weights["w"].shape == (5,) and pm.weights["b"].shape == (1,)
    probe = reg_cols(seed=8)
    assert_same_table(jm.transform(JTable(dict(probe))),
                      pm.transform(PTable(dict(probe))), atol=1e-9)
    # the carried weights alone
    assert_same_table(
        jm.transform(JTable(dict(probe))),
        PL.LinearRegressionModel(weights=jm.weights, **CPU).transform(
            PTable(dict(probe))), atol=1e-12)


# ---- TrainClassifier / TrainRegressor -------------------------------------

@functools.lru_cache(maxsize=None)
def jax_train_classifier(raw, steps):
    learner = JL.LogisticRegression(max_iter=steps)
    return JTC.TrainClassifier(model=learner).fit(
        JTable(mixed_cols(raw=raw)))


@pytest.mark.parametrize("raw,steps", [(False, 60), (False, 200), (True, 1),
                                       (True, 60)])
def test_train_classifier_restores_string_labels(raw, steps):
    jm = jax_train_classifier(raw, steps)
    pm = PTC.TrainClassifier(model=PL.LogisticRegression(
        max_iter=steps, **CPU)).fit(PTable(mixed_cols(raw=raw)))
    assert list(pm.label_model.levels.levels) == ["high", "low", "mid"]
    assert pm.featurizer.strategies == jm.featurizer.strategies
    w_tol, s_tol, margin = (1e-2, 5e-2, 0.1) if raw else (1e-4, 1e-5, 1e-3)
    close_weights(jm.inner_model.weights, pm.inner_model.weights, w_tol)
    probe = mixed_cols(n=120, seed=9, raw=raw)
    jo = jm.transform(JTable(dict(probe)))
    po = pm.transform(PTable(dict(probe)))
    assert po.column_names == jo.column_names
    close_scores(jo["scores"], po["scores"], s_tol, margin)
    top2 = np.sort(jo["scores"], axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] >= margin
    assert sure.mean() > 0.5
    assert list(po["prediction"][sure]) == list(jo["prediction"][sure])
    assert set(po["prediction"]) <= {"high", "low", "mid"}
    cm = po.get_meta("prediction")["categorical"]
    assert list(cm.levels) == ["high", "low", "mid"]


def test_train_classifier_without_reindexing_and_its_default_device():
    t = PTable({"x": np.arange(40.0) % 7, "label": (np.arange(40) % 2)
                .astype(np.float64)})
    m = PTC.TrainClassifier(reindex_label=False, **CPU).fit(t)
    assert m.label_model is None
    assert m.inner_model.device == "cpu"
    assert m.transform(t)["prediction"].dtype == np.float64
    # the default learner gets the wrapper's device; a given one keeps its
    assert PTC.TrainClassifier().device is None
    own = PL.LogisticRegression(max_iter=3, **CPU)
    m2 = PTC.TrainClassifier(model=own, reindex_label=False).fit(t)
    assert m2.inner_model.device == "cpu"


@functools.lru_cache(maxsize=None)
def jax_train_regressor():
    return JTC.TrainRegressor().fit(JTable(regressor_cols()))


def regressor_cols(n=400, seed=3):
    rng = np.random.default_rng(seed)
    cols = mixed_cols(n=n, seed=seed)
    del cols["label"]
    cols["n"] = rng.integers(0, 5, n)
    cols["label"] = cols["a"] * 2 - cols["b"] + (cols["cat"] == "red") \
        + 0.1 * rng.normal(size=n)
    return cols


def test_train_regressor_on_mixed_columns():
    jm = jax_train_regressor()
    pm = PTC.TrainRegressor(**CPU).fit(PTable(regressor_cols()))
    assert pm.featurizer.strategies == jm.featurizer.strategies
    close_weights(jm.inner_model.weights, pm.inner_model.weights, 1e-4)
    probe = regressor_cols(n=100, seed=11)
    jo = jm.transform(JTable(dict(probe)))
    po = pm.transform(PTable(dict(probe)))
    scale = np.abs(jo["prediction"]).max()
    assert_same_table(jo, po, atol=1e-9 * scale)


# ---- persistence, devices, precision --------------------------------------

@pytest.mark.parametrize("which", ["classifier", "regressor", "logistic",
                                   "linear"])
def test_save_load_transform_equal(which, tmp_path):
    if which == "classifier":
        model = PTC.TrainClassifier(model=PL.LogisticRegression(
            max_iter=30, **CPU)).fit(PTable(mixed_cols()))
        table = PTable(mixed_cols(n=50, seed=12))
    elif which == "regressor":
        model = PTC.TrainRegressor(**CPU).fit(PTable(regressor_cols()))
        table = PTable(regressor_cols(n=50, seed=13))
    elif which == "logistic":
        model = PL.LogisticRegression(max_iter=30, **CPU).fit(
            PTable(cls_cols()))
        table = PTable(cls_cols(n=50, seed=14))
    else:
        model = PL.LinearRegression(**CPU).fit(PTable(reg_cols()))
        table = PTable(reg_cols(seed=15))
    path = os.path.join(tmp_path, "m")
    model.save(path)
    loaded = PipelineStage.load(path)
    assert type(loaded) is type(model)
    a, b = model.transform(table), loaded.transform(table)
    assert a.approx_equals(b, rtol=0.0, atol=0.0)
    assert list(a["prediction"]) == list(b["prediction"])


@pytest.mark.parametrize("make", [
    lambda: PL.LogisticRegression().fit(PTable(cls_cols(n=20))),
    lambda: PL.LinearRegression().fit(PTable(reg_cols(n=20))),
    lambda: PL.LogisticRegressionModel(weights={
        "w": np.zeros((6, 2), np.float32), "b": np.zeros(2, np.float32)})
    .transform(PTable(cls_cols(n=20))),
    lambda: PTC.TrainClassifier().fit(PTable(mixed_cols(n=30))),
    lambda: PTC.TrainRegressor().fit(PTable(regressor_cols(n=30)))])
def test_the_default_device_is_the_card(make):
    """No card here: the default raises instead of running on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


@pytest.mark.parametrize("before", ["none", "tf32", "ieee", "legacy"])
def test_full_f32_restores_the_callers_precision(before):
    """Inside the block cuBLAS's f32 matmuls are "ieee"; after it the
    caller's setting is back, set by either API (the older `allow_tf32`
    reads again afterwards without raising)."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    try:
        if before == "legacy":
            matmul.allow_tf32 = True
        else:
            matmul.fp32_precision = before
        want = matmul.fp32_precision
        with PL._full_f32():
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == want
        PL.LogisticRegression(max_iter=2, **CPU).fit(PTable(cls_cols(n=20)))
        assert matmul.fp32_precision == want
        if before == "legacy":
            assert matmul.allow_tf32 is True
    finally:
        matmul.fp32_precision = saved


def test_concurrent_fits_keep_full_f32_until_the_last_leaves(monkeypatch):
    """Two fits whose `_full_f32` blocks overlap: the one that leaves
    second still runs in "ieee" after the other left, the caller's "tf32"
    is back once both are out, and each fit equals a fit run alone."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    t = PTable(cls_cols(n=60, seed=7))
    alone = PL.LogisticRegression(max_iter=30, **CPU).fit(t).weights
    real = PL._full_f32
    both_in = threading.Barrier(2, timeout=30)
    first_out = threading.Event()
    order_lock = threading.Lock()
    left, seen = [], []

    @contextlib.contextmanager
    def overlapping():
        with real():
            both_in.wait()
            yield
            with order_lock:
                first = not left
                left.append(threading.get_ident())
            if not first:
                assert first_out.wait(30)
                seen.append(matmul.fp32_precision)
        if first:
            first_out.set()

    fits, errors = [], []

    def fit():
        try:
            fits.append(PL.LogisticRegression(max_iter=30, **CPU).fit(t))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    monkeypatch.setattr(PL, "_full_f32", overlapping)
    try:
        matmul.fp32_precision = "tf32"
        threads = [threading.Thread(target=fit) for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not errors, errors
        assert seen == ["ieee"]
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = saved
    assert len(fits) == 2
    for m in fits:
        for k in ("w", "b"):
            np.testing.assert_array_equal(m.weights[k], alone[k])


def test_solve_ridge_is_the_closed_form():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(30, 3))
    y = rng.normal(size=30)
    xb = np.concatenate([x, np.ones((30, 1))], axis=1)
    want = np.linalg.solve(xb.T @ xb + 0.5 * np.eye(4), xb.T @ y)
    got = PL.solve_ridge(torch.as_tensor(x), torch.as_tensor(y), 0.5)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
