"""The port's sparse (CSR) GBDT path held against the JAX package's on the
CPU: the host containers exactly, the COO histogram with its implicit-zero
fix-up at 1e-4, sparse boosters by the tie rule of
tests/torch_gbdt_compare.py, sparse against dense training as the JAX
package's tests/test_gbdt_sparse.py checks it, and the default CUDA
entry, which raises without a card.  The hashed-text estimator path
(featurizer -> GBDTClassifier over 2^18 features) is example 02's test
in test_torch_online_stats.py.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.gbdt import Booster as JBooster, TrainConfig as JConfig
from mmlspark_tpu.gbdt import sparse as JS
from mmlspark_tpu.gbdt import tree as JT
from mmlspark_tpu_torch.gbdt import (Booster, TrainConfig,
                                     histogram as PH, sparse as PS,
                                     tree as PT)
from mmlspark_tpu_torch.models.statistics import roc_auc

from torch_gbdt_compare import (TOL, compare_fits, following_splits,
                                recorded_splits)

torch.set_num_threads(2)


def _sparse_data(n=500, f=40, density=0.15, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)) * (rng.random((n, f)) < density)
    logits = 2 * x[:, 0] - x[:, 1] + x[:, 2]
    y = (logits + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    return x, y


def _pairs_column(seed=3, n=40, f=64, dup=True):
    rng = np.random.default_rng(seed)
    col = np.empty(n, object)
    for i in range(n):
        k = rng.integers(0, 9)
        idx = rng.integers(0, f, size=k).astype(np.uint32)
        if dup and k:
            idx[-1] = idx[0]                 # a collision to sum
        col[i] = (idx, rng.normal(size=k).astype(np.float32))
    return col


def _csr_equal(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    assert a.shape == b.shape


# ---- host containers ---------------------------------------------------

def test_csr_matrix_equals_the_jax_package():
    x, _ = _sparse_data()
    p, j = PS.CSRMatrix.from_dense(x), JS.CSRMatrix.from_dense(x)
    _csr_equal(p, j)
    idx = np.array([3, 7, 7, 0])
    _csr_equal(p.take_rows(idx), j.take_rows(idx))
    mask = np.arange(len(x)) < 50
    _csr_equal(p[mask], j[mask])
    np.testing.assert_array_equal(p.to_dense(), x)
    col = _pairs_column()
    _csr_equal(PS.CSRMatrix.from_pairs_column(col, num_features=64),
               JS.CSRMatrix.from_pairs_column(col, num_features=64))
    _csr_equal(PS.CSRMatrix.from_pairs_column(col),
               JS.CSRMatrix.from_pairs_column(col))
    with pytest.raises(ValueError, match="out of range"):
        PS.CSRMatrix.from_pairs_column(col, num_features=8)


def test_sparse_bin_mapper_and_view_equal_the_jax_package():
    x, _ = _sparse_data(n=300, f=20)
    x[:, 5] = np.where(x[:, 5] != 0, 1.0, 0.0)      # an indicator feature
    csr = PS.CSRMatrix.from_dense(x)
    for max_bin in (7, 31, 255):
        p = PS.SparseBinMapper(max_bin, sample_count=200).fit(csr)
        j = JS.SparseBinMapper(max_bin, sample_count=200).fit(
            JS.CSRMatrix.from_dense(x))
        assert p.to_dict() == j.to_dict()
        pv, jv = p.transform(csr), j.transform(JS.CSRMatrix.from_dense(x))
        for k in ("row_nz", "feat_nz", "bin_nz", "zero_bins"):
            np.testing.assert_array_equal(getattr(pv, k), getattr(jv, k))
        rows = np.arange(300) % 37
        feats = np.arange(300) % 20
        np.testing.assert_array_equal(pv[rows, feats], jv[rows, feats])
        np.testing.assert_array_equal(pv[:, 5], jv[:, 5])
        for f in (0, 5, 19):
            for b in (0, 1, max_bin // 2, max_bin):
                assert p.bin_upper_value(f, b) == j.bin_upper_value(f, b)
    bad = PS.CSRMatrix(np.array([np.nan]), np.array([0]),
                       np.array([0, 1, 1, 1]), (3, 2))
    with pytest.raises(ValueError, match="NaN"):
        PS.SparseBinMapper(max_bin=7).fit(bad)


@pytest.mark.parametrize("num_features", [40, 1 << 18])
def test_effective_sparse_max_bin_equals_the_jax_package(num_features):
    for leaves in (7, 31, 255):
        for max_bin in (15, 255):
            assert PS.effective_sparse_max_bin(max_bin, num_features,
                                               leaves) == \
                JS.effective_sparse_max_bin(max_bin, num_features, leaves)


# ---- the COO histogram -------------------------------------------------

def _coo_case(n, f, max_bin, seed):
    x, _ = _sparse_data(n=n, f=f, seed=seed)
    m = PS.SparseBinMapper(max_bin=max_bin).fit(PS.CSRMatrix.from_dense(x))
    view = m.transform(PS.CSRMatrix.from_dense(x))
    rng = np.random.default_rng(seed + 1)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.random(n).astype(np.float32)
    w = (rng.random(n) < 0.9).astype(np.float32)
    mask = rng.random(n) < 0.7
    return m, view, grad, hess, w, mask


@pytest.mark.parametrize("n,f,max_bin", [(300, 10, 15), (500, 64, 63),
                                         (200, 3000, 7)])
def test_build_histogram_coo_matches_the_jax_package(n, f, max_bin):
    m, view, grad, hess, w, mask = _coo_case(n, f, max_bin, seed=n)
    arrays = (view.feat_nz, view.bin_nz, view.row_nz, view.zero_bins, grad,
              hess, w, mask)
    want = np.asarray(JS.build_histogram_coo(*map(jnp.asarray, arrays),
                                             m.num_bins, f))
    got = PS.build_histogram_coo(*map(torch.as_tensor, arrays), m.num_bins, f)
    assert got.shape == (f, m.num_bins, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the implicit-zero fix-up leaves every feature with the node totals
    totals = (np.stack([grad * w, hess * w, w], 1) * mask[:, None]).sum(0)
    np.testing.assert_allclose(got.numpy().sum(axis=1),
                               np.broadcast_to(totals, (f, 3)), rtol=1e-4,
                               atol=1e-4)
    # ... and equals the dense histogram of the densified codes
    codes = np.stack([view.column(j) for j in range(f)], 1).astype(np.uint8)
    dense = PH.build_histogram(*map(torch.as_tensor, (codes, grad, hess, w,
                                                      mask)), m.num_bins)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_padding_entries_are_dropped():
    m, view, grad, hess, w, mask = _coo_case(100, 6, 7, seed=9)
    feat = np.concatenate([view.feat_nz, np.full(5, -1, np.int32)])
    bins = np.concatenate([view.bin_nz, np.full(5, 3, np.uint8)])
    row = np.concatenate([view.row_nz, np.full(5, -1, np.int32)])
    args = (grad, hess, w, mask)
    padded = PS.build_histogram_coo(*map(torch.as_tensor, (
        feat, bins, row, view.zero_bins) + args), m.num_bins, 6)
    plain = PS.build_histogram_coo(*map(torch.as_tensor, (
        view.feat_nz, view.bin_nz, view.row_nz, view.zero_bins) + args),
        m.num_bins, 6)
    np.testing.assert_array_equal(padded.numpy(), plain.numpy())


# ---- sparse boosters ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_sparse_fit(boosting):
    x, y = _sparse_data(n=400, f=30)
    cfg = dict(objective="binary", num_iterations=8, num_leaves=7,
               min_data_in_leaf=5, boosting_type=boosting, max_bin=63)
    with recorded_splits(JT) as calls:
        b = JBooster(JConfig(**cfg)).fit(JS.CSRMatrix.from_dense(x), y)
    return b, calls, cfg


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_sparse_booster_matches_the_jax_package(boosting):
    j, jcalls, cfg = _jax_sparse_fit(boosting)
    x, y = _sparse_data(n=400, f=30)
    csr = PS.CSRMatrix.from_dense(x)
    with following_splits(PT, jcalls, f"sparse {boosting}"):
        p = Booster(TrainConfig(**cfg)).fit(csr, y, device="cpu")
    assert isinstance(p.bin_mapper, PS.SparseBinMapper)
    compare_fits(j, p, label=f"sparse {boosting}")
    np.testing.assert_allclose(p._raw_scores(csr),
                               j._raw_scores(JS.CSRMatrix.from_dense(x)),
                               rtol=TOL, atol=TOL)
    # CSR scoring goes through the host traversal on bin codes
    np.testing.assert_array_equal(p.raw_scores_jit(csr), p._raw_scores(csr))
    # the model string crosses both ways
    np.testing.assert_array_equal(
        Booster.from_model_string(j.model_string()).score(csr),
        j.score(JS.CSRMatrix.from_dense(x)))
    np.testing.assert_array_equal(
        JBooster.from_model_string(p.model_string()).score(
            JS.CSRMatrix.from_dense(x)), p.score(csr))


def test_sparse_dense_training_parity():
    """Same data through the CSR and dense paths of the port: both learn
    the signal and agree closely (binning differs by design), as
    tests/test_gbdt_sparse.py holds the JAX package."""
    x, y = _sparse_data(n=600, f=30)
    cfg = TrainConfig(objective="binary", num_iterations=30, num_leaves=15,
                      min_data_in_leaf=5, parallelism="serial", max_bin=63)
    dense = Booster(cfg).fit(x, y, device="cpu")
    sparse = Booster(TrainConfig(**vars(cfg))).fit(
        PS.CSRMatrix.from_dense(x), y, device="cpu")
    p_dense = dense.score(x)
    p_sparse = sparse.score(PS.CSRMatrix.from_dense(x))
    auc_d, auc_s = roc_auc(y, p_dense), roc_auc(y, p_sparse)
    assert auc_s > 0.95
    assert auc_d > 0.9 and abs(auc_d - auc_s) < 0.05
    assert np.corrcoef(p_dense, p_sparse)[0, 1] > 0.9


def test_sparse_eval_early_stopping_and_leaf_shap():
    x, y = _sparse_data(n=500, f=20)
    csr = PS.CSRMatrix.from_dense(x)
    hold = PS.CSRMatrix.from_dense(x[:100])
    cfg = TrainConfig(objective="binary", num_iterations=40, num_leaves=7,
                      min_data_in_leaf=5, early_stopping_round=5)
    b = Booster(cfg).fit(csr, y, eval_set=[("valid", hold, y[:100])],
                         device="cpu")
    assert b.eval_history and b.best_iteration >= 0
    assert b.predict_leaf(csr).shape == (500, len(b.trees))
    shap = b.features_shap(hold)
    assert shap.shape == (100, 21)
    np.testing.assert_allclose(shap.sum(axis=1), b._raw_scores(hold),
                               atol=1e-6)
    with pytest.raises(ValueError, match="matching representations"):
        Booster(TrainConfig(**vars(cfg))).fit(x, y, init_model=b,
                                              device="cpu")
    with pytest.raises(ValueError, match="categorical"):
        Booster(TrainConfig(objective="binary",
                            categorical_features=[2])).fit(csr, y,
                                                           device="cpu")


def test_the_default_cuda_entry_raises_without_a_card():
    x, y = _sparse_data(n=100, f=8)
    csr = PS.CSRMatrix.from_dense(x)
    view = PS.SparseBinMapper(7).fit_transform(csr)
    b = PS.SparseHistogramBuilder(view, 8, device="cpu")
    # a world-1 gloo mesh builds the single-device histogram, and a
    # data-parallel fit on it equals the serial one
    from torch_world1 import world1_gloo

    arrs = (np.linspace(-1, 1, 100), np.full(100, 0.25), np.ones(100))
    want = b.build(*b.device_arrays(*arrs), b.node_mask(np.ones(100, bool)))
    kw = dict(objective="binary", num_iterations=2, num_leaves=4,
              min_data_in_leaf=5)
    serial = Booster(TrainConfig(**kw)).fit(csr, y, device="cpu")
    with world1_gloo() as mesh:
        mb = PS.SparseHistogramBuilder(view, 8, mesh=mesh, device="cpu")
        got = mb.build(*mb.device_arrays(*arrs),
                       mb.node_mask(np.ones(100, bool)))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        meshed = Booster(TrainConfig(parallelism="data_parallel",
                                     **kw)).fit(csr, y, mesh=mesh,
                                                device="cpu")
    compare_fits(serial, meshed, label="world-1 sparse")
    assert b.build_local(*b.device_arrays(np.ones(100), np.ones(100),
                                          np.ones(100)),
                         b.node_mask(np.ones(100, bool))).shape == (1, 8, 8, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PS.SparseHistogramBuilder(view, 8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Booster(TrainConfig(objective="binary",
                                num_iterations=1)).fit(csr, y)
