"""The port's hashed featurizer (mmlspark_tpu_torch.online) and model
statistics (mmlspark_tpu_torch.models.statistics) held against the JAX
package's on the same inputs: murmur3 and the featurizer's indices and
values exactly, `roc_auc` and the statistics stages at 1e-12, and example
02's pipeline (featurizer -> GBDTClassifier, 12 iterations, 7 leaves) at
a small row count with the same trees as the JAX package's (the tie rule
of tests/torch_gbdt_compare.py).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu import Pipeline as JPipeline, Table as JTable
from mmlspark_tpu.gbdt import GBDTClassifier as JCls
from mmlspark_tpu.gbdt import tree as JT
from mmlspark_tpu.models import statistics as JStats
from mmlspark_tpu.online import featurizer as JF
from mmlspark_tpu.online import hashing as JHash
from mmlspark_tpu_torch import Pipeline, Table
from mmlspark_tpu_torch.gbdt import GBDTClassifier, SparseBinMapper
from mmlspark_tpu_torch.gbdt.sparse import effective_sparse_max_bin
from mmlspark_tpu_torch.gbdt import tree as PT
from mmlspark_tpu_torch.models import statistics as PStats
from mmlspark_tpu_torch.online import (FeatureHasher, VectorZipper,
                                       VowpalWabbitFeaturizer,
                                       VowpalWabbitInteractions,
                                       murmurhash3_32, sparse_to_padded)

from torch_gbdt_compare import (TOL, compare_fits, following_splits,
                                recorded_splits)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair_cols_equal(a, b):
    assert len(a) == len(b)
    for (ia, va), (ib, vb) in zip(a, b):
        assert ia.dtype == ib.dtype and va.dtype == vb.dtype
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(va, vb)


# ---- hashing and featurization -----------------------------------------

def test_murmur3_known_vectors_and_the_jax_package():
    assert murmurhash3_32(b"", 0) == 0
    assert murmurhash3_32(b"", 1) == 0x514E28B7
    assert murmurhash3_32(b"hello", 0) == 0x248BFA47
    assert murmurhash3_32(b"The quick brown fox jumps over the lazy dog",
                          0) == 0x2E4FF723
    rng = np.random.default_rng(0)
    for _ in range(200):
        data = bytes(rng.integers(0, 256, size=int(rng.integers(0, 40)),
                                  dtype=np.uint8))
        seed = int(rng.integers(0, 2**32))
        assert murmurhash3_32(data, seed) == JHash.murmurhash3_32(data, seed)
    p, j = FeatureHasher(num_bits=10, seed=7), JHash.FeatureHasher(10, 7)
    for ns, f in [("ns", "feat"), ("ns2", "feat"), ("a", "x" * 17)]:
        assert p(ns, f) == j(ns, f) and 0 <= p(ns, f) < 1024
        assert p.namespace_seed(ns) == j.namespace_seed(ns)


def _mixed():
    return {
        "num": np.array([1.5, 0.0, -2.0, 3.0]),
        "cat": np.array(["red", "blue", "red", "green"], object),
        "txt": np.array(["good movie", "bad film", "good film", ""], object),
        "vec": np.array([[1.0, 0.0], [0.5, 2.0], [0.0, 0.0], [3.0, 1.0]],
                        np.float32),
        "flag": np.array([True, False, True, True]),
        "map": np.array([{"a": 1.0, "b": "x"}, {}, {"a": 2.0}, None],
                        object),
        "seq": np.array([["u", "v"], [], ["u"], ["w", "w"]], object),
    }


@pytest.mark.parametrize("num_bits,sum_collisions", [(16, True), (2, True),
                                                     (2, False)])
def test_featurizer_indices_and_values_equal_the_jax_package(num_bits,
                                                             sum_collisions):
    kw = dict(input_cols=list(_mixed()), string_split_cols=["txt"],
              num_bits=num_bits, seed=3, sum_collisions=sum_collisions)
    got = VowpalWabbitFeaturizer(**kw).transform(Table(_mixed()))
    want = JF.VowpalWabbitFeaturizer(**kw).transform(JTable(_mixed()))
    _pair_cols_equal(got["features"], want["features"])
    assert got.get_meta("features") == want.get_meta("features") == \
        {"num_bits": num_bits}
    pi, pv = sparse_to_padded(got["features"], max_active=5)
    ji, jv = JF.sparse_to_padded(want["features"], max_active=5)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)


def test_interactions_and_zipper_equal_the_jax_package():
    cols = {"a": np.array(["u1", "u2", "u1"], object),
            "b": np.array(["i1 i2", "i3", ""], object)}
    pt, jt = Table(dict(cols)), JTable(dict(cols))
    for mod, t in ((None, pt), (JF, jt)):
        f = VowpalWabbitFeaturizer if mod is None else \
            mod.VowpalWabbitFeaturizer
        t = f(input_cols=["a"], output_col="fa", num_bits=12).transform(t)
        t = f(input_cols=["b"], output_col="fb", num_bits=12,
              string_split_cols=["b"]).transform(t)
        if mod is None:
            pt = t
        else:
            jt = t
    got = VowpalWabbitInteractions(input_cols=["fa", "fb"],
                                   num_bits=12).transform(pt)
    want = JF.VowpalWabbitInteractions(input_cols=["fa", "fb"],
                                       num_bits=12).transform(jt)
    _pair_cols_equal(got["interactions"], want["interactions"])
    z = VectorZipper(input_cols=["a", "b"], output_col="z").transform(pt)
    zj = JF.VectorZipper(input_cols=["a", "b"], output_col="z").transform(jt)
    assert list(z["z"]) == list(zj["z"])
    with pytest.raises(ValueError, match=">= 2"):
        VowpalWabbitInteractions(input_cols=["fa"]).transform(pt)


# ---- statistics --------------------------------------------------------

def test_roc_auc_and_confusion_matrix_equal_the_jax_package():
    rng = np.random.default_rng(1)
    for n in (10, 333, 2000):
        y = (rng.random(n) < 0.4).astype(np.float64)
        s = np.round(rng.random(n) + 0.3 * y, 2)    # ties among the scores
        assert abs(PStats.roc_auc(y, s) - JStats.roc_auc(y, s)) <= 1e-12
        p = (s > 0.6).astype(np.float64)
        np.testing.assert_array_equal(PStats.confusion_matrix(y, p, 2),
                                      JStats.confusion_matrix(y, p, 2))
    assert np.isnan(PStats.roc_auc(np.ones(4), np.arange(4.0)))


def _stats_equal(got, want):
    assert got.column_names == want.column_names
    for c in got.column_names:
        a, b = got[c], want[c]
        if a.dtype == object:
            for x, y in zip(a, b):
                np.testing.assert_allclose(np.asarray(x, np.float64),
                                           np.asarray(y, np.float64),
                                           rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64), rtol=1e-12,
                                       atol=1e-12, equal_nan=True, err_msg=c)


def _stats_tables():
    rng = np.random.default_rng(2)
    n = 200
    y = (rng.random(n) < 0.5).astype(np.float64)
    p1 = np.clip(0.3 * y + 0.7 * rng.random(n), 0, 1)
    probs = np.stack([1 - p1, p1], 1)
    multi = rng.integers(0, 3, n).astype(np.float64)
    reg = rng.normal(size=n)
    return {
        "binary": {"label": y, "prediction": (p1 > 0.5).astype(np.float64),
                   "scores": probs},
        "labels -1/1": {"label": 2 * y - 1,
                        "prediction": 2 * (p1 > 0.5) - 1.0, "scores": p1},
        "multiclass": {"label": multi,
                       "prediction": np.where(rng.random(n) < 0.7, multi,
                                              rng.integers(0, 3, n))
                       .astype(np.float64)},
        "regression": {"label": reg,
                       "prediction": reg + 0.1 * rng.normal(size=n)},
    }


@pytest.mark.parametrize("case", ["binary", "labels -1/1", "multiclass",
                                  "regression"])
@pytest.mark.parametrize("metric", ["all", "classification", "regression"])
def test_compute_model_statistics_equals_the_jax_package(case, metric):
    if metric == "classification" and case == "regression":
        metric = "all"
    cols = _stats_tables()[case]
    got = PStats.ComputeModelStatistics(evaluation_metric=metric).transform(
        Table(dict(cols)))
    want = JStats.ComputeModelStatistics(evaluation_metric=metric).transform(
        JTable(dict(cols)))
    _stats_equal(got, want)


@pytest.mark.parametrize("metric", ["classification", "regression"])
def test_per_instance_statistics_equal_the_jax_package(metric):
    cols = dict(_stats_tables()["binary"])
    got = PStats.ComputePerInstanceStatistics(
        evaluation_metric=metric).transform(Table(dict(cols)))
    want = JStats.ComputePerInstanceStatistics(
        evaluation_metric=metric).transform(JTable(dict(cols)))
    _stats_equal(got, want)


# ---- example 02 --------------------------------------------------------

def _example_02():
    spec = importlib.util.spec_from_file_location(
        "example_02", os.path.join(ROOT, "examples",
                                   "02_hashed_text_gbdt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_02_pipeline_trains_the_jax_package_trees():
    """examples/02_hashed_text_gbdt.py's pipeline at 300 rows on both
    packages: the same trees, probabilities at 1e-4, the same AUC."""
    table = _example_02().synthetic_reviews(n=300)
    cols = {c: table[c] for c in table.column_names}
    feat_kw = dict(input_cols=["text"], output_col="features", num_bits=18,
                   string_split_cols=["text"])
    gbdt_kw = dict(num_iterations=12, num_leaves=7, min_data_in_leaf=10,
                   max_bin=15)
    jpipe = JPipeline(stages=[JF.VowpalWabbitFeaturizer(**feat_kw),
                              JCls(parallelism="serial", **gbdt_kw)])
    ppipe = Pipeline(stages=[VowpalWabbitFeaturizer(**feat_kw),
                             GBDTClassifier(device="cpu", **gbdt_kw)])
    hashed = VowpalWabbitFeaturizer(**feat_kw).transform(Table(dict(cols)))
    active = np.unique(np.concatenate([p[0] for p in hashed["features"]])
                       .astype(np.int64))
    with recorded_splits(JT, active) as jcalls:
        jmodel = jpipe.fit(JTable(dict(cols)))
    with following_splits(PT, jcalls, "example 02", features=active):
        pmodel = ppipe.fit(Table(dict(cols)))
    pb, jb = pmodel.stages[1].booster, jmodel.stages[1].booster
    assert isinstance(pb.bin_mapper, SparseBinMapper)
    assert pb.bin_mapper.num_features_ == 1 << 18
    # the bins the [2^18, B, 3] histograms' budget leaves
    assert pb.bin_mapper.max_bin == effective_sparse_max_bin(15, 1 << 18, 7)
    compare_fits(jb, pb, label="example 02")
    got = pmodel.transform(Table(dict(cols)))
    want = jmodel.transform(JTable(dict(cols)))
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=TOL, atol=TOL)
    y = np.asarray(cols["label"])
    auc = PStats.roc_auc(y, got["probability"][:, 1])
    assert abs(auc - JStats.roc_auc(y, want["probability"][:, 1])) <= 1e-12
    assert auc > 0.9
    stats = PStats.ComputeModelStatistics(
        evaluation_metric="classification", scores_col="probability"
    ).transform(got)
    assert abs(stats["AUC"][0] - auc) <= 1e-12
