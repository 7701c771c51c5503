"""The port's explainers (mmlspark_tpu_torch.explainers) held against the
JAX package's on the same inputs, made from seeds with numpy, on the CPU
(`device="cpu"`; LIME's default is the card, and without one it raises).

Tolerances, from the spread measured between the two packages on the
CPU (both solve in f32, the JAX package by one vmapped solve per (row,
target), the port by one batched solve per row for all targets):
- the four solvers at s > 2d: coefficients within 1e-5 of max |coef| and
  intercepts within 1e-5 of max |y| (measured at most 3.5e-7 and 3.9e-7);
  a rank-deficient design (s <= d, where the 1e-6 ridge alone picks the
  coefficients: they part by 2.1e-2 of max |coef|) by its fitted values,
  within 1e-4 of max |y| (measured 3.0e-7), and its surrogate R² within
  1e-4.
- `slic_segments`, `masked_image`, the samplers' designs and masked /
  emitted sample tables: equal, element for element (the same numpy code
  and `np.random.default_rng` draws).
- LIME explanations (the f32 solve) within 1e-4 of max |coef| (measured
  at most 5.2e-7); SHAP explanations (both packages' host f64 solve, the
  same code) within 1e-6 (measured equal); `_r2` within 1e-4 (measured at
  most 1.2e-7).
- `ImageLIME` over the resnet18 `ImageFeaturizer` at 64² (f32 on both
  sides, bridged weights; the explained score is class 0's
  log-probability, which random weights do not saturate as they do the
  probability): the model's scores within 1e-4 of the JAX stack's
  largest (test_torch_featurizer.py's limit; measured 2.8e-6) and the
  explanation within 1e-3 of max |coef| (measured 9.1e-6: a fit of 24
  samples over 16 superpixels magnifies the scores' gap).
"""
import functools

import numpy as np
import pytest
import scipy.special
import torch

import jax.numpy as jnp

from mmlspark_tpu import LambdaTransformer as JLambda, Table as JTable
from mmlspark_tpu import explainers as JE
from mmlspark_tpu.explainers import regression as JR
from mmlspark_tpu.models.bundle import FlaxBundle
from mmlspark_tpu.models.image_featurizer import ImageFeaturizer as JFeaturizer
from mmlspark_tpu.core.pipeline import PipelineModel as JPipelineModel

from mmlspark_tpu_torch import LambdaTransformer, Table
from mmlspark_tpu_torch import explainers as PE
from mmlspark_tpu_torch.core.pipeline import PipelineModel
from mmlspark_tpu_torch.explainers import regression as PR
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer

from torch_port_util import random_flax_variables
from torch_tables import assert_same_table

torch.set_num_threads(2)

CPU = {"device": "cpu"}
W = np.array([2.0, -3.0, 0.5], np.float32)
LIME_RTOL, SHAP_RTOL, R2_ATOL = 1e-4, 1e-6, 1e-4


# ---- shared scoring functions (numpy; either package's Table) -----------

def _matrix(col):
    a = np.asarray(col)
    if a.dtype == object:
        a = np.stack([np.asarray(v, np.float32) for v in a])
    return a.astype(np.float32)


def linear_fn(t):
    return t.with_column("scores", _matrix(t["features"]) @ W)


def two_target_fn(t):
    s = _matrix(t["features"]) @ W
    out = np.empty(len(t), dtype=object)
    for i, (a, b) in enumerate(zip(s, np.tanh(s))):
        out[i] = np.array([a, b], np.float32)
    return t.with_column("scores", out)


def columns_fn(t):
    s = 2.0 * np.asarray(t["a"]) - 3.0 * np.asarray(t["b"]) + \
        0.5 * np.asarray(t["c"]) ** 2
    return t.with_column("scores", s.astype(np.float32))


def brightness_fn(t):
    """Mean brightness of the left half, and of the top half."""
    vals = np.empty(len(t), dtype=object)
    for i, img in enumerate(t["image"]):
        a = np.asarray(img, np.float32)
        vals[i] = np.array([a[:, : a.shape[1] // 2].mean(),
                            a[: a.shape[0] // 2].mean()], np.float32)
    return t.with_column("scores", vals)


def keyword_fn(t):
    vals = np.array([1.0 * ("magic" in str(s).split())
                     + 0.5 * ("spell" in str(s).split()) for s in t["text"]],
                    np.float32)
    return t.with_column("scores", vals)


def _image(seed, h=32, w=32):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32) * 0.3
    img[:, : w // 2] += 0.6
    return img


def _image_table(table_cls, n=2):
    imgs = np.empty(n, dtype=object)
    for i in range(n):
        imgs[i] = _image(20 + i)
    return table_cls({"image": imgs})


def _tab(table_cls, n=5, seed=2):
    rng = np.random.default_rng(seed)
    return table_cls({"features": rng.normal(size=(n, 3)).astype(np.float32)})


def _cols(table_cls, n=8, seed=6):
    rng = np.random.default_rng(seed)
    return table_cls({k: rng.normal(size=n).astype(np.float32)
                      for k in "abc"})


def _texts(table_cls):
    return table_cls({"text": np.asarray(
        ["the magic word appears here once", "no special token at all",
         "a spell and magic", "magic"], object)})


# ---- the solvers ---------------------------------------------------------

SHAPES = [(3, 64, 6, 2), (4, 128, 20, 3), (2, 96, 30, 1)]


def _problem(n, s, d, t, seed):
    rng = np.random.default_rng(seed)
    X = (rng.random((n, s, d)) < 0.7).astype(np.float32)
    X[:, 0] = 1.0
    Y = (X[:, :, :t] * 2.0 - X[:, :, -t:] +
         0.3 * rng.normal(size=(n, s, t))).astype(np.float32)
    Wt = np.exp(-rng.random((n, s))).astype(np.float32)
    return X, Y, Wt


def _close(got, want, rtol, scale=None):
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(scale, 1e-30))


@pytest.mark.parametrize("solver", ["wls", "lasso"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_batched_solvers_match_jax(solver, shape):
    X, Y, Wt = _problem(*shape, seed=sum(shape))
    if solver == "wls":
        jc, ji = JR.batch_weighted_least_squares(X, Y, Wt)
        pc, pi = PR.batch_weighted_least_squares(X, Y, Wt, **CPU)
    else:
        jc, ji = JR.batch_lasso(X, Y, Wt, 0.01)
        pc, pi = PR.batch_lasso(X, Y, Wt, 0.01, **CPU)
    assert pc.dtype == torch.float32 and pc.device.type == "cpu"
    assert tuple(pc.shape) == np.asarray(jc).shape == (shape[0], shape[3],
                                                       shape[2])
    _close(pc.numpy(), np.asarray(jc), 1e-5)
    _close(pi.numpy(), np.asarray(ji), 1e-5, scale=float(np.abs(Y).max()))


@pytest.mark.parametrize("solver", ["wls", "lasso"])
def test_single_solvers_match_jax(solver):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 8)).astype(np.float32)
    w_true = np.zeros(8, np.float32)
    w_true[0], w_true[3] = 3.0, -2.0
    y = X @ w_true + 1.5
    w = np.ones(300, np.float32)
    if solver == "wls":
        jc, ji = JR.weighted_least_squares(X, y, w)
        pc, pi = PR.weighted_least_squares(X, y, w, **CPU)
        np.testing.assert_allclose(pc.numpy(), w_true, atol=1e-3)
    else:
        jc, ji = JR.lasso(X, y, w, alpha=0.05)
        pc, pi = PR.lasso(X, y, w, alpha=0.05, **CPU)
        coefs = pc.numpy()
        assert abs(coefs[0] - 3.0) < 0.2 and abs(coefs[3] + 2.0) < 0.2
        assert np.all(np.abs(np.delete(coefs, [0, 3])) < 0.1)
    _close(pc.numpy(), np.asarray(jc), 1e-5)
    assert abs(float(pi) - float(ji)) <= 1e-5 * 3.0


def test_rank_deficient_wls_is_held_by_its_fitted_values():
    """s <= d: the 1e-6 ridge on the normalized weights alone picks the
    coefficients, which f32 cannot pin; the fits agree."""
    X, Y, Wt = _problem(3, 12, 20, 2, seed=9)
    jc, ji = map(np.asarray, JR.batch_weighted_least_squares(X, Y, Wt))
    pc, pi = (a.numpy() for a in PR.batch_weighted_least_squares(X, Y, Wt,
                                                                 **CPU))
    fit_j = np.einsum("nsd,ntd->nst", X, jc) + ji[:, None, :]
    fit_p = np.einsum("nsd,ntd->nst", X, pc) + pi[:, None, :]
    _close(fit_p, fit_j, 1e-4, scale=float(np.abs(Y).max()))
    r2_j = JE.base.LocalExplainer._fit_r2(X, Wt, Y, jc, ji)
    r2_p = PE.base.LocalExplainer._fit_r2(X, Wt, Y, pc, pi)
    np.testing.assert_allclose(r2_p, r2_j, rtol=0, atol=1e-4)


def test_host_f64_solve_is_the_jax_packages():
    X, Y, Wt = _problem(2, 40, 5, 2, seed=4)
    Wt[:, :2] = 1e6  # KernelSHAP's anchors
    for a, b in zip(PR.np_batch_weighted_least_squares(X, Y, Wt),
                    JR.np_batch_weighted_least_squares(X, Y, Wt)):
        np.testing.assert_array_equal(a, b)


def test_lime_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y, Wt = _problem(1, 16, 3, 1, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PR.batch_weighted_least_squares(X, Y, Wt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PR.lasso(X[0], Y[0, :, 0], Wt[0], 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PE.TabularLIME(model=LambdaTransformer(linear_fn),
                       num_samples=16).transform(_tab(Table))
    # KernelSHAP solves on the host in f64, as the JAX package does
    assert "device" not in PE.TabularSHAP.params()
    out = PE.TabularSHAP(model=LambdaTransformer(linear_fn),
                         num_samples=16).transform(_tab(Table))
    assert len(out["explanation"]) == 5


# ---- superpixels ---------------------------------------------------------

@pytest.mark.parametrize("case", ["float32x32", "uint8_48x40", "gray_24x24"])
def test_slic_label_maps_equal_the_jax_packages(case):
    rng = np.random.default_rng(len(case))
    if case == "float32x32":
        img, kw = rng.random((32, 32, 3)).astype(np.float32), {}
    elif case == "uint8_48x40":
        img = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
        kw = {"n_segments": 30, "compactness": 13.0}
    else:
        img, kw = rng.random((24, 24)).astype(np.float32), {"n_segments": 9}
    got, want = PE.slic_segments(img, **kw), JE.slic_segments(img, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    keep = (rng.random(int(got.max()) + 1) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(PE.masked_image(img, got, keep, 0.25),
                                  JE.masked_image(img, want, keep, 0.25))


def test_superpixel_transformer_matches_jax():
    kw = dict(input_col="image", output_col="sp", cell_size=8.0)
    got = PE.SuperpixelTransformer(**kw).transform(_image_table(Table))
    want = JE.SuperpixelTransformer(**kw).transform(_image_table(JTable))
    assert_same_table(want, got)


# ---- every explainer class against the JAX class -------------------------

def _case(name, pkg, table_cls, lam):
    """(stage, table) of one explainer class, from the package `pkg`."""
    E = pkg
    cpu = CPU if (pkg is PE and "LIME" in name) else {}
    if name == "TabularLIME":
        return E.TabularLIME(model=lam(linear_fn), num_samples=64, seed=3,
                             **cpu), _tab(table_cls)
    if name == "TabularSHAP":
        return E.TabularSHAP(model=lam(columns_fn), input_cols=["a", "b", "c"],
                             num_samples=64, seed=7), _cols(table_cls)
    if name == "VectorLIME":
        return E.VectorLIME(model=lam(two_target_fn), num_samples=64, seed=4,
                            regularization=0.01, target_classes=[0, 1],
                            **cpu), _tab(table_cls)
    if name == "VectorSHAP":
        return E.VectorSHAP(model=lam(two_target_fn), num_samples=48, seed=8,
                            target_classes=[1, 0]), _tab(table_cls)
    if name == "ImageLIME":
        return E.ImageLIME(model=lam(brightness_fn), num_samples=48, seed=11,
                           cell_size=8.0, **cpu), _image_table(table_cls)
    if name == "ImageSHAP":
        return E.ImageSHAP(model=lam(brightness_fn), num_samples=48, seed=12,
                           cell_size=8.0, background=0.5), \
            _image_table(table_cls)
    if name == "TextLIME":
        return E.TextLIME(model=lam(keyword_fn), num_samples=48, seed=13,
                          **cpu), _texts(table_cls)
    if name == "TextSHAP":
        return E.TextSHAP(model=lam(keyword_fn), num_samples=48, seed=14), \
            _texts(table_cls)
    raise KeyError(name)


EXPLAINERS = ["TabularLIME", "TabularSHAP", "VectorLIME", "VectorSHAP",
              "ImageLIME", "ImageSHAP", "TextLIME", "TextSHAP"]


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    stage, table = _case(name, JE, JTable, JLambda)
    samples, states = stage._build_samples(table)
    return samples, np.asarray(states), stage.transform(table)


@pytest.mark.parametrize("name", EXPLAINERS)
def test_explainer_matches_jax(name):
    j_samples, j_states, want = _jax_run(name)
    stage, table = _case(name, PE, Table, LambdaTransformer)
    samples, states = stage._build_samples(table)
    # equal designs and sample tables, bit for bit
    np.testing.assert_array_equal(states, j_states)
    assert_same_table(j_samples, samples)
    got = stage.transform(table)
    assert got.column_names == want.column_names
    tol = LIME_RTOL if "LIME" in name else SHAP_RTOL
    g = np.stack([np.asarray(v) for v in got["explanation"]])
    w = np.stack([np.asarray(v) for v in want["explanation"]])
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    _close(g, w, tol)
    np.testing.assert_allclose(np.asarray(got["explanation_r2"], np.float64),
                               np.asarray(want["explanation_r2"], np.float64),
                               rtol=0, atol=R2_ATOL)
    if name.startswith("Text"):
        assert [list(t) for t in got["tokens"]] == \
            [list(t) for t in want["tokens"]]


# ---- the JAX package's own checks, on the port ---------------------------

def test_tabular_lime_recovers_weights():
    out = PE.TabularLIME(model=LambdaTransformer(linear_fn), num_samples=256,
                         seed=3, **CPU).transform(_tab(Table))
    for row in out["explanation"]:
        np.testing.assert_allclose(np.asarray(row)[0], W, atol=0.05)
    assert np.all(np.stack(list(out["explanation_r2"])) > 0.99)


def test_tabular_shap_additivity():
    tab = _tab(Table)
    out = PE.TabularSHAP(model=LambdaTransformer(linear_fn), num_samples=64,
                         seed=5).transform(tab)
    x = tab["features"]
    for i, row in enumerate(out["explanation"]):
        np.testing.assert_allclose(np.asarray(row)[0],
                                   W * (x[i] - x.mean(axis=0)), atol=0.05)


def test_image_lime_locality():
    img = np.zeros((32, 32, 3), np.float32)
    img[:, :16] = 1.0
    imgs = np.empty(1, dtype=object)
    imgs[0] = img
    out = PE.ImageLIME(model=LambdaTransformer(brightness_fn),
                       num_samples=128, seed=11, cell_size=8.0,
                       target_classes=[0], **CPU).transform(
                           Table({"image": imgs}))
    coefs = np.asarray(out["explanation"][0])[0]
    labels = PE.slic_segments(img, n_segments=(32 * 32) // 64,
                              compactness=13.0)
    left_ids = np.unique(labels[:, :12])
    right_ids = np.setdiff1d(np.unique(labels[:, 20:]), left_ids)
    assert coefs[left_ids].mean() > coefs[right_ids].mean() + 1e-4


def test_text_explainers_find_the_keyword():
    t = Table({"text": ["the magic word appears here once"]})
    out = PE.TextLIME(model=LambdaTransformer(keyword_fn), num_samples=128,
                      seed=13, **CPU).transform(t)
    toks = out["tokens"][0]
    assert toks[np.argmax(np.asarray(out["explanation"][0])[0][:len(toks)])] \
        == "magic"
    t = Table({"text": ["alpha beta magic gamma"]})
    out = PE.TextSHAP(model=LambdaTransformer(keyword_fn), num_samples=64,
                      seed=14).transform(t)
    phi = np.asarray(out["explanation"][0])[0][: len(out["tokens"][0])]
    assert out["tokens"][0][np.argmax(phi)] == "magic"
    assert abs(phi.sum() - 1.0) < 0.15  # additivity: f(x) - f(null)


def test_explainer_roundtrip():
    from torch_fuzzing import fuzz_transformer

    fuzz_transformer(PE.TabularLIME(model=LambdaTransformer(linear_fn),
                                    num_samples=64, seed=15, **CPU),
                     _tab(Table))


# ---- ImageLIME over the featurizer stack ---------------------------------

HW = 64


def probs_fn(t):
    p = scipy.special.log_softmax(np.stack([np.asarray(v, np.float64)
                                        for v in t["logits"]]), axis=-1)
    return t.with_column("scores", p[:, 0].astype(np.float32))


@functools.lru_cache(maxsize=None)
def _featurizer_stack_run():
    variables = random_flax_variables("resnet18", seed=7, num_classes=3,
                                      hw=HW)
    jb = FlaxBundle("resnet18", {"num_classes": 3, "dtype": jnp.float32},
                    variables=variables, input_shape=(HW, HW, 3))
    tb = from_flax_variables("resnet18", variables, {"num_classes": 3},
                             input_shape=(HW, HW, 3), dtype="float32")
    rng = np.random.default_rng(3)
    imgs = np.empty(1, dtype=object)
    imgs[0] = (rng.random((HW, HW, 3)) * 255.0).astype(np.float32)
    kw = dict(input_col="image", output_col="logits", cut_output_layers=0,
              batch_size=16)
    jstack = JPipelineModel([JFeaturizer(bundle=jb, **kw), JLambda(probs_fn)])
    pstack = PipelineModel([ImageFeaturizer(bundle=tb, **kw, **CPU),
                            LambdaTransformer(probs_fn)])
    lime = dict(num_samples=24, seed=5, cell_size=16.0)
    want = JE.ImageLIME(model=jstack, **lime).transform(
        JTable({"image": imgs}))
    exp = PE.ImageLIME(model=pstack, **lime, **CPU)
    got = exp.transform(Table({"image": imgs}))
    samples, _ = exp._build_samples(Table({"image": imgs}))
    j_scores = JE.ImageLIME(model=jstack, **lime)._build_samples(
        JTable({"image": imgs}))[0]
    return (np.asarray(jstack.transform(j_scores)["scores"]),
            np.asarray(pstack.transform(samples)["scores"]), want, got, imgs)


def test_image_lime_on_the_featurizer_stack_matches_jax():
    """test_explainers.py's flagship stack (ImageLIME over the FULL
    ImageFeaturizer -> head), on weights bridged from the JAX bundle."""
    j_scores, p_scores, want, got, imgs = _featurizer_stack_run()
    assert p_scores.shape == j_scores.shape == (24,)
    _close(p_scores, j_scores, 1e-4)
    coefs = np.asarray(got["explanation"][0])
    n_segments = len(np.unique(PE.slic_segments(imgs[0], (HW * HW) // 256,
                                                compactness=13.0)))
    assert coefs.shape == (1, n_segments) and np.all(np.isfinite(coefs))
    _close(coefs, np.asarray(want["explanation"][0]), 1e-3)
