"""The port's recommendation package (mmlspark_tpu_torch.recommendation: SAR
on the device, the indexer, ranking metrics, the adapter and the
train-validation split as host copies) held against the JAX package's on
the same ratings, on the CPU.

Tolerances: co-occurrence counts are exact (0/1 products summed in f32,
exact below 2^24); jaccard and lift within 1e-6 (one f32 division each,
of the same counts); user scores (affinity @ similarity) within 1e-5 of
their largest; the recommended items equal exactly, ties included (the
port's top-k takes the lower index among equal scores, as `lax.top_k`;
zero scores and masked seen items tie often); the ranking metrics of the
same recommendations equal.
"""
import functools
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu import Table as JTable
from mmlspark_tpu import recommendation as JR

from mmlspark_tpu_torch import Table as PTable
from mmlspark_tpu_torch import recommendation as PR
from mmlspark_tpu_torch.recommendation import sar as PS

torch.set_num_threads(2)

CPU = {"device": "cpu"}


def _ratings_cols(seed=0, n_users=40, n_items=25, n=500):
    rng = np.random.default_rng(seed)
    return {
        "user": rng.integers(0, n_users, n).astype(np.int64),
        "item": rng.integers(0, n_items, n).astype(np.int64),
        "rating": rng.integers(1, 6, n).astype(np.float32),
        "ts": rng.uniform(0, 200 * 86400.0, n),
    }


def _group_cols():
    """3 user groups with distinct tastes over 9 items (the reference
    suite's fixture)."""
    rng = np.random.default_rng(0)
    rows_u, rows_i, rows_r = [], [], []
    for u in range(30):
        group = u % 3
        for i in range(group * 3, group * 3 + 3):
            rows_u.append(u)
            rows_i.append(i)
            rows_r.append(5.0)
        rows_u.append(u)
        rows_i.append(int(rng.integers(0, 9)))
        rows_r.append(1.0)
    return {"user": np.array(rows_u, np.int64),
            "item": np.array(rows_i, np.int64),
            "rating": np.array(rows_r, np.float32)}


@functools.lru_cache(maxsize=None)
def _sar(fn, threshold, ts):
    cols = _ratings_cols()
    kw = dict(similarity_function=fn, support_threshold=threshold,
              timestamp_col="ts" if ts else "")
    return (JR.SAR(**kw).fit(JTable(dict(cols))),
            PR.SAR(**kw, **CPU).fit(PTable(dict(cols))), cols)


@pytest.mark.parametrize("fn,threshold,ts", [
    ("cooccurrence", 1, False), ("cooccurrence", 4, True),
    ("jaccard", 1, True), ("jaccard", 3, False), ("lift", 1, False),
    ("lift", 4, True)])
def test_sar_similarities_and_affinities_match_jax(fn, threshold, ts):
    jm, pm, _ = _sar(fn, threshold, ts)
    np.testing.assert_array_equal(pm.user_affinity, jm.user_affinity)
    sj = np.asarray(jm.item_similarity)
    sp = np.asarray(pm.item_similarity)
    assert sp.dtype == sj.dtype == np.float32 and sp.shape == sj.shape
    if fn == "cooccurrence":
        np.testing.assert_array_equal(sp, sj)
    else:
        np.testing.assert_allclose(sp, sj, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(sp == 0, sj == 0)  # the support cut


def test_cooccurrence_is_exact_on_the_card_products():
    b = (np.random.default_rng(1).random((300, 40)) < 0.3).astype(np.float32)
    c = PS._cooccurrence(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(c, (b.T.astype(np.int64) @ b).astype(
        np.float32))


@pytest.mark.parametrize("k", [5, 25, 60])
def test_recommend_for_all_users_equals_jax_ties_included(k):
    jm, pm, _ = _sar("jaccard", 1, True)
    rj, rp = jm.recommend_for_all_users(k), pm.recommend_for_all_users(k)
    np.testing.assert_array_equal(rp["user"], rj["user"])
    for a, b in zip(rj["recommendations"], rp["recommendations"]):
        assert b.dtype == a.dtype == np.int64
        np.testing.assert_array_equal(b, a)
    for a, b in zip(rj["scores"], rp["scores"]):
        np.testing.assert_allclose(b, a, atol=1e-5 * max(1.0, np.abs(a).max()))
    assert all(len(r) <= 25 for r in rp["recommendations"])


def test_ties_on_zero_scores_take_the_lower_item():
    """Support 10 zeroes most similarities: a third of the top-10 slots
    are unseen items tied at 0."""
    jm, pm, _ = _sar("cooccurrence", 10, True)
    rj, rp = jm.recommend_for_all_users(10), pm.recommend_for_all_users(10)
    zeros = 0
    for a, b, s in zip(rj["recommendations"], rp["recommendations"],
                       rj["scores"]):
        np.testing.assert_array_equal(b, a)
        zeros += int((np.asarray(s) == 0).sum())
    assert zeros >= 100


def test_transform_scores_match_jax():
    jm, pm, cols = _sar("lift", 1, False)
    q = {"user": np.array([0, 3, 39, 40, -1]),
         "item": np.array([1, 24, 0, 2, 3])}
    pj = np.asarray(jm.transform(JTable(dict(q)))["prediction"])
    pp = np.asarray(pm.transform(PTable(dict(q)))["prediction"])
    assert pp.dtype == pj.dtype
    np.testing.assert_allclose(pp, pj, atol=1e-5 * max(1.0, np.abs(pj).max()))
    assert pp[3] == pp[4] == 0.0


def test_a_jax_model_transforms_on_the_port():
    jm, _, _ = _sar("jaccard", 3, False)
    pm = PR.SARModel(user_affinity=np.asarray(jm.user_affinity),
                     item_similarity=np.asarray(jm.item_similarity), **CPU)
    rj, rp = jm.recommend_for_all_users(7), pm.recommend_for_all_users(7)
    for a, b in zip(rj["recommendations"], rp["recommendations"]):
        np.testing.assert_array_equal(b, a)


def test_indexer_matches_jax():
    cols = {"customerID": np.asarray(["alice", "bob", "alice", "dan"]),
            "itemID": np.asarray(["x", "y", "y", "z"]),
            "rating": np.array([1.0, 2.0, 3.0, 4.0])}
    jm = JR.RecommendationIndexer().fit(JTable(dict(cols)))
    pm = PR.RecommendationIndexer().fit(PTable(dict(cols)))
    oj, op = jm.transform(JTable(dict(cols))), pm.transform(PTable(dict(cols)))
    for c in ("user", "item", "rating"):
        np.testing.assert_array_equal(op[c], oj[c])
    assert pm.recover_user(1) == jm.recover_user(1)
    unseen = {"customerID": np.asarray(["carol"]), "itemID": np.asarray(["x"]),
              "rating": np.array([1.0])}
    assert len(pm.transform(PTable(dict(unseen)))) == 0


def test_ranking_metrics_equal_the_reference():
    rng = np.random.default_rng(2)
    for _ in range(20):
        recs = list(rng.permutation(30)[:10])
        truth = list(rng.choice(30, int(rng.integers(0, 8)), replace=False))
        for fn in ("ndcg_at_k", "map_at_k", "precision_at_k", "recall_at_k"):
            for k in (1, 5, 10):
                assert getattr(PR, fn)(recs, truth, k) == \
                    getattr(JR, fn)(recs, truth, k)


def test_adapter_evaluator_and_tvs_match_jax():
    cols = _group_cols()
    jt, pt = JTable(dict(cols)), PTable(dict(cols))
    ja = JR.RankingAdapter(recommender=JR.SAR(support_threshold=1), k=5).fit(jt)
    pa = PR.RankingAdapter(recommender=PR.SAR(support_threshold=1, **CPU),
                           k=5).fit(pt)
    rj, rp = ja.transform(jt), pa.transform(pt)
    assert set(rp.column_names) == set(rj.column_names)
    for a, b in zip(rj["recommendations"], rp["recommendations"]):
        assert list(b) == list(a)
    for metric in ("ndcgAt", "map", "precisionAtk", "recallAtK"):
        ej = JR.RankingEvaluator(metric_name=metric, k=5).evaluate(rj)
        ep = PR.RankingEvaluator(metric_name=metric, k=5).evaluate(rp)
        assert ep == pytest.approx(ej, abs=1e-12)
    grid = [{"similarity_function": "jaccard"},
            {"similarity_function": "lift"}]
    tj = JR.RankingTrainValidationSplit(
        estimator=JR.SAR(support_threshold=1), param_grid=grid,
        evaluator=JR.RankingEvaluator(metric_name="ndcgAt", k=5),
        train_ratio=0.75, seed=2).fit(jt)
    tp = PR.RankingTrainValidationSplit(
        estimator=PR.SAR(support_threshold=1, **CPU), param_grid=grid,
        evaluator=PR.RankingEvaluator(metric_name="ndcgAt", k=5),
        train_ratio=0.75, seed=2).fit(pt)
    np.testing.assert_allclose(tp.validation_metrics, tj.validation_metrics,
                               atol=1e-12)
    trj, tvj = JR.per_user_split(jt, "user", 0.75, seed=1)
    trp, tvp = PR.per_user_split(pt, "user", 0.75, seed=1)
    np.testing.assert_array_equal(trp["item"], trj["item"])
    np.testing.assert_array_equal(tvp["item"], tvj["item"])


# the reference checkout's committed SAR fixtures, as
# tests/test_recommendation.py reads them
_REF_RES = "/root/reference/core/src/test/resources"


@pytest.mark.parametrize("threshold,fn,fixture", [
    (1, "cooccurrence", "sim_count1.csv.gz"),
    (3, "lift", "sim_lift3.csv.gz"),
    (3, "jaccard", "sim_jac3.csv.gz"),
])
def test_sar_similarity_parity_vs_reference_fixtures(threshold, fn, fixture):
    import csv
    import gzip

    if not os.path.isdir(_REF_RES):
        pytest.skip("reference checkout not available")
    with gzip.open(os.path.join(_REF_RES, "demoUsage.csv.gz"), "rt") as f:
        rows = [r for r in csv.DictReader(f)
                if r.get("userId") and r.get("productId")]
    users = sorted({r["userId"] for r in rows})
    items = sorted({r["productId"] for r in rows})
    uidx = {u: i for i, u in enumerate(users)}
    iidx = {p: i for i, p in enumerate(items)}
    table = PTable({
        "user": np.array([uidx[r["userId"]] for r in rows], np.int64),
        "item": np.array([iidx[r["productId"]] for r in rows], np.int64)})
    model = PR.SAR(similarity_function=fn, support_threshold=threshold,
                   **CPU).fit(table)
    S = np.asarray(model.item_similarity)
    with gzip.open(os.path.join(_REF_RES, fixture), "rt") as f:
        reader = csv.reader(f)
        header = next(reader)[1:]
        truth = {row[0]: np.array([float(x) for x in row[1:]], np.float32)
                 for row in reader}
    cols = [iidx[j] for j in header]
    for item_i, vals in truth.items():
        np.testing.assert_allclose(S[iidx[item_i]][cols], vals, rtol=2e-5,
                                   atol=2e-6)
