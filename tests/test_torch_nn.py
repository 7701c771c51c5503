"""The port's nearest-neighbour stages (mmlspark_tpu_torch.nn: the ball
trees, a host copy, and KNN / ConditionalKNN, whose scores and top-k run
on the device) held against the JAX package's on the same keys and
queries, on the CPU.

Tolerances: the ball trees are the same host numpy code, so their matches
are equal.  KNN indices equal JAX's exactly, ties included (the port's
top-k takes the lower index among equal scores, as `jax.lax.top_k`
does); the inner products within 1e-5 (f32 products summed in another
order).  The tie tests build exact ties: duplicated keys, all-zero keys,
and conditioner masks that leave fewer than k allowed rows (-inf).
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.nn import ball_tree as JBT
from mmlspark_tpu.nn import knn as JK

from mmlspark_tpu_torch import Table as PTable
from mmlspark_tpu_torch.nn import ball_tree as PBT
from mmlspark_tpu_torch.nn import knn as PK
from mmlspark_tpu_torch.ops.topk import topk_lower_index

torch.set_num_threads(2)

CPU = {"device": "cpu"}


def _matches(ms):
    return [(m.index, m.value, m.distance) for m in ms]


def test_ball_tree_results_are_identical():
    rng = np.random.default_rng(0)
    keys = rng.normal(size=(300, 6)).astype(np.float32)
    values = list(range(300))
    labels = [i % 4 for i in range(300)]
    jt, pt = JBT.BallTree(keys, values, leaf_size=8), \
        PBT.BallTree(keys, values, leaf_size=8)
    jc = JBT.ConditionalBallTree(keys, values, labels, leaf_size=8)
    pc = PBT.ConditionalBallTree(keys, values, labels, leaf_size=8)
    for q in rng.normal(size=(20, 6)).astype(np.float32):
        assert _matches(pt.find_maximum_inner_products(q, 5)) == \
            _matches(jt.find_maximum_inner_products(q, 5))
        assert _matches(pc.find_maximum_inner_products(q, 4, allowed={1, 3})) \
            == _matches(jc.find_maximum_inner_products(q, 4, allowed={1, 3}))


def _tied_keys(seed=1):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2, 3, size=(64, 4)).astype(np.float32)
    keys[10:20] = keys[3]           # ten copies of one key
    keys[40:48] = 0.0               # all-zero keys: score 0 for any query
    return keys


def _knn_tables(keys, queries, seed=2):
    cols = {"features": keys, "values": np.arange(len(keys)) * 10.0}
    return (JTable(dict(cols)), PTable(dict(cols)),
            JTable({"features": queries}), PTable({"features": queries}))


def _same_output(jo, po, with_label=False):
    assert len(jo) == len(po)
    for a, b in zip(jo, po):
        assert [m["value"] for m in b] == [m["value"] for m in a]
        np.testing.assert_allclose([m["distance"] for m in b],
                                   [m["distance"] for m in a], atol=1e-5)
        if with_label:
            assert [m["label"] for m in b] == [m["label"] for m in a]


@pytest.mark.parametrize("k", [1, 5, 17])
def test_knn_indices_equal_jax_with_ties(k):
    keys = _tied_keys()
    rng = np.random.default_rng(3)
    queries = rng.integers(-2, 3, size=(30, 4)).astype(np.float32)
    queries[0] = 0.0                # every score 0: the first k keys
    queries[1] = keys[3]            # the ten copies tie at the top
    jk, pk, jq, pq = _knn_tables(keys, queries)
    jm = JK.KNN(k=k).fit(jk)
    pm = PK.KNN(k=k, **CPU).fit(pk)
    jo = jm.transform(jq)["output"]
    po = pm.transform(pq)["output"]
    _same_output(jo, po)
    assert [m["value"] for m in po[0]] == [10.0 * i for i in range(k)]


def test_knn_on_continuous_data_and_k_above_the_key_count():
    rng = np.random.default_rng(4)
    keys = rng.normal(size=(50, 8)).astype(np.float32)
    queries = rng.normal(size=(12, 8)).astype(np.float32)
    jk, pk, jq, pq = _knn_tables(keys, queries)
    for k in (3, 80):
        jo = JK.KNN(k=k).fit(jk).transform(jq)["output"]
        po = PK.KNN(k=k, **CPU).fit(pk).transform(pq)["output"]
        _same_output(jo, po)


def test_chunks_do_not_change_the_result(monkeypatch):
    rng = np.random.default_rng(5)
    keys = _tied_keys()
    queries = rng.integers(-2, 3, size=(25, 4)).astype(np.float32)
    want = PK._batched_topk(keys, queries, 6, device="cpu")
    monkeypatch.setattr(PK, "_SCORE_BYTES", 4 * len(keys) * 4)  # 4 rows
    assert PK._chunk_rows(len(keys)) == 4
    got = PK._batched_topk(keys, queries, 6, device="cpu")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_conditional_knn_equals_jax_with_masked_ties():
    keys = _tied_keys(seed=6)
    labels = np.asarray(["a", "b", "c", "d"] * 16)
    rng = np.random.default_rng(7)
    queries = rng.integers(-2, 3, size=(20, 4)).astype(np.float32)
    conds = np.empty(20, object)
    for i in range(20):
        conds[i] = [["a"], ["b", "d"], ["zzz"], ["a", "b", "c", "d"]][i % 4]
    cols = {"features": keys, "values": np.arange(64.0), "labels": labels}
    jm = JK.ConditionalKNN(k=20, label_col="labels").fit(JTable(dict(cols)))
    pm = PK.ConditionalKNN(k=20, label_col="labels", **CPU).fit(
        PTable(dict(cols)))
    q = {"features": queries, "conditioner": conds}
    jo = jm.transform(JTable(dict(q)))["output"]
    po = pm.transform(PTable(dict(q)))["output"]
    _same_output(jo, po, with_label=True)
    assert po[2] == []              # no key carries the label
    assert len(po[0]) == 16         # fewer allowed rows than k


def test_query_one_uses_the_ball_tree():
    rng = np.random.default_rng(8)
    keys = rng.normal(size=(40, 5)).astype(np.float32)
    jm = JK.KNN(k=3).fit(JTable({"features": keys,
                                 "values": np.arange(40.0)}))
    pm = PK.KNN(k=3, **CPU).fit(PTable({"features": keys,
                                        "values": np.arange(40.0)}))
    q = rng.normal(size=5).astype(np.float32)
    assert _matches(pm.query_one(q)) == _matches(jm.query_one(q))
    assert _matches(pm.query_one(q, k=5)) == _matches(jm.query_one(q, k=5))


def test_topk_lower_index_is_jax_top_k():
    import jax

    rng = np.random.default_rng(9)
    x = rng.integers(0, 4, size=(7, 33)).astype(np.float32)
    x[2] = -np.inf
    x[3, :5] = np.inf
    for k in (0, 1, 4, 33):
        jv, ji = jax.lax.top_k(x, k)
        pv, pi = topk_lower_index(torch.from_numpy(x), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError):
        topk_lower_index(torch.from_numpy(x), 34)


def test_topk_ties_go_low_whatever_torch_topk_picks(monkeypatch):
    """`torch.topk` on CUDA may return any of several equal values: a
    stand-in that prefers the HIGHER index among ties must not change the
    result."""
    import jax

    real = torch.topk

    def high_first(x, k, dim=-1):
        v, i = real(torch.flip(x, [dim]), k, dim=dim)
        return v, x.shape[dim] - 1 - i

    monkeypatch.setattr(torch, "topk", high_first)
    rng = np.random.default_rng(10)
    x = rng.integers(0, 3, size=(9, 40)).astype(np.float32)
    x[4] = -np.inf
    for k in (1, 3, 10):
        assert not np.array_equal(high_first(torch.from_numpy(x), k)[1],
                                  np.asarray(jax.lax.top_k(x, k)[1]))
        pv, pi = topk_lower_index(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(x, k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = PK.KNN(k=2).fit(PTable({"features": np.eye(3, dtype=np.float32),
                                "values": np.arange(3.0)}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.transform(PTable({"features": np.eye(3, dtype=np.float32)}))
