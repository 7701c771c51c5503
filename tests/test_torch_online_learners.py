"""The port's online learners (mmlspark_tpu_torch.online.learners and
contextual_bandit, over K1's plain loop on the CPU) held against the JAX
package's on the same hashed tables, made from seeds with numpy.

Tolerances: the pass is the reference's per-example AdaGrad arithmetic in
f32, step for step; the two differ only in the order of each example's
prediction sum (and XLA's fusion of the scan body), a rounding that the
later examples carry on.  Weights are held within 1e-5 of max |w| after
1 to 6 passes (measured at most 1.9e-7 on these tables), per-pass losses
within 1e-5 relative, margins within 1e-5 of max |margin|, and the
bandit's IPS / SNIPS estimates equal where no greedy choice is a tie
within 1e-5.
"""
import functools

import numpy as np
import pytest
import torch

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.online import FeatureHasher as JHasher
from mmlspark_tpu.online import VowpalWabbitFeaturizer as JFeat
from mmlspark_tpu.online import learners as JL
from mmlspark_tpu.online import contextual_bandit as JCB

from mmlspark_tpu_torch import Table as PTable
from mmlspark_tpu_torch.online import VowpalWabbitFeaturizer as PFeat
from mmlspark_tpu_torch.online import learners as PL
from mmlspark_tpu_torch.online import contextual_bandit as PCB
from mmlspark_tpu_torch.ops import online_pass as K1

torch.set_num_threads(2)

CPU = {"device": "cpu"}
W_TOL = 1e-5


def _vec_rows(x):
    rows = np.empty(len(x), dtype=object)
    for i in range(len(x)):
        rows[i] = x[i]
    return rows


def _cls_cols(n=200, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = (x[:, 0] - 2 * x[:, 1] + 0.5 * rng.normal(size=n) > 0).astype(np.int64)
    return {"vec": _vec_rows(x), "label": y}


def _reg_cols(n=150, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = x @ np.array([1.0, -2.0, 0.5, 0.0], np.float32)
    return {"vec": _vec_rows(x), "label": y}


def _hashed(cols, bits):
    j = JFeat(input_cols=["vec"], num_bits=bits).transform(JTable(dict(cols)))
    p = PFeat(input_cols=["vec"], num_bits=bits).transform(PTable(dict(cols)))
    return j, p


def _close_w(wj, wp, tol=W_TOL):
    wj, wp = np.asarray(wj), np.asarray(wp)
    assert wj.shape == wp.shape
    scale = max(float(np.abs(wj).max()), 1e-6)
    err = float(np.abs(wj - wp).max()) / scale
    assert err <= tol, err


@functools.lru_cache(maxsize=None)
def _cls_fit(passes, bits=12, seed=0, l1=0.0, l2=0.0):
    j, p = _hashed(_cls_cols(seed=seed), bits)
    kw = dict(num_passes=passes, learning_rate=0.5, l1=l1, l2=l2)
    return (JL.VowpalWabbitClassifier(**kw).fit(j),
            PL.VowpalWabbitClassifier(**kw, **CPU).fit(p), j, p)


@pytest.mark.parametrize("passes", [1, 3])
def test_classifier_weights_losses_and_predictions(passes):
    mj, mp, j, p = _cls_fit(passes)
    _close_w(mj.weights, mp.weights)
    sj, sp = mj.performance_statistics, mp.performance_statistics
    assert list(sp.column_names) == list(sj.column_names)
    np.testing.assert_allclose(sp["average_loss"], sj["average_loss"],
                               rtol=1e-5)
    for c in ("pass", "num_examples", "num_shards"):
        np.testing.assert_array_equal(sp[c], sj[c])
    oj, op = mj.transform(j), mp.transform(p)
    np.testing.assert_allclose(op["probability"], oj["probability"],
                               atol=1e-5)
    far = np.abs(np.asarray(oj["probability"]) - 0.5) > 1e-4
    np.testing.assert_array_equal(np.asarray(op["prediction"])[far],
                                  np.asarray(oj["prediction"])[far])
    assert op["prediction"].dtype == oj["prediction"].dtype


def test_l1_and_l2_terms():
    mj, mp, _, _ = _cls_fit(2, l1=1e-3, l2=1e-2)
    _close_w(mj.weights, mp.weights)


@pytest.mark.parametrize("passes", [1, 6])
def test_regressor(passes):
    j, p = _hashed(_reg_cols(), 11)
    kw = dict(num_passes=passes, learning_rate=0.3)
    mj = JL.VowpalWabbitRegressor(**kw).fit(j)
    mp = PL.VowpalWabbitRegressor(**kw, **CPU).fit(p)
    _close_w(mj.weights, mp.weights)
    pj = np.asarray(mj.transform(j)["prediction"])
    pp = np.asarray(mp.transform(p)["prediction"])
    np.testing.assert_allclose(pp, pj, atol=1e-5 * np.abs(pj).max())


def test_warm_start_from_the_jax_weights():
    mj, _, j, p = _cls_fit(1)
    kw = dict(num_passes=1, initial_model=np.asarray(mj.weights))
    m2j = JL.VowpalWabbitClassifier(**kw).fit(j)
    m2p = PL.VowpalWabbitClassifier(**kw, **CPU).fit(p)
    _close_w(m2j.weights, m2p.weights)


def _raw_table(idx_rows, val_rows, y):
    col = np.empty(len(idx_rows), dtype=object)
    for i, (a, b) in enumerate(zip(idx_rows, val_rows)):
        col[i] = (np.asarray(a, np.uint32), np.asarray(b, np.float32))
    return {"features": col, "label": np.asarray(y, np.float64)}


def _dup_cols(seed=7, n=80):
    """Rows with repeated indices, explicit zero values, all-zero rows and
    an empty row: the reference's duplicate and padding semantics."""
    rng = np.random.default_rng(seed)
    idx_rows, val_rows, y = [], [], []
    for r in range(n):
        k = int(rng.integers(0, 7))
        ind = rng.integers(0, 16, size=k)
        if k >= 2 and r % 3 == 0:
            ind[1] = ind[0]  # a duplicate
        val = rng.normal(size=k).astype(np.float32)
        if k >= 3 and r % 4 == 1:
            val[2] = 0.0  # an explicit zero
        if r % 10 == 5:
            val[:] = 0.0  # an all-zero row
        idx_rows.append(ind)
        val_rows.append(val)
        y.append(float(rng.random() > 0.5))
    return _raw_table(idx_rows, val_rows, y)


@pytest.mark.parametrize("cls", ["VowpalWabbitClassifier",
                                 "VowpalWabbitRegressor"])
def test_duplicates_zeros_and_empty_rows(cls):
    cols = _dup_cols()
    kw = dict(num_passes=2, num_bits=4, learning_rate=0.5, l2=1e-3)
    mj = getattr(JL, cls)(**kw).fit(JTable(dict(cols)))
    mp = getattr(PL, cls)(**kw, **CPU).fit(PTable(dict(cols)))
    _close_w(mj.weights, mp.weights)
    np.testing.assert_allclose(mp.performance_statistics["average_loss"],
                               mj.performance_statistics["average_loss"],
                               rtol=1e-5)


def test_plan_rows_layout():
    idx = torch.tensor([[5, 3, 5, 0, 3, 5], [2, 2, 0, 0, 0, 0],
                        [0, 0, 0, 0, 0, 0]])
    val = torch.tensor([[1., 2., 3., 0., 4., 5.], [0., 7., 0., 0., 0., 0.],
                        [0., 0., 0., 0., 0., 0.]])
    plan = K1.plan_rows(idx, val)
    assert plan.nnz.tolist() == [5, 1, 0]
    assert plan.idx[0, :5].tolist() == [3, 3, 5, 5, 5]
    assert plan.val[0, :5].tolist() == [2., 4., 1., 3., 5.]  # slot order kept
    assert plan.run[0].tolist() == [2, 0, 3, 0, 0, 0]
    assert plan.run[1].tolist() == [1, 0, 0, 0, 0, 0]
    assert plan.run[2].tolist() == [0] * 6
    assert plan.idx.dtype == torch.int32 and plan.run.dtype == torch.int32


def test_a_duplicate_adds_each_slots_square_and_step():
    """One example, index 2 in two slots: g2 gains both squares before
    either slot reads it, and w both steps from the same read."""
    w = torch.tensor([0.0, 0.0, 0.5, 0.0])
    g2 = torch.zeros(4)
    plan = K1.plan_rows(torch.tensor([[2, 2]]), torch.tensor([[1.0, 2.0]]))
    y = torch.tensor([0.0])
    K1.online_pass(w, g2, plan, y, lr=0.1, loss="squared")
    pred = 0.5 * 1.0 + 0.5 * 2.0
    gi = np.float32(pred) * np.array([1.0, 2.0], np.float32)
    want_g2 = np.float32(gi[0] ** 2 + gi[1] ** 2)
    denom = np.sqrt(want_g2) + np.float32(1e-8)
    want_w = np.float32(0.5) + np.float32(-0.1) * (gi[0] / denom) + \
        np.float32(-0.1) * (gi[1] / denom)
    assert g2[2].item() == pytest.approx(float(want_g2), rel=1e-6)
    assert w[2].item() == pytest.approx(float(want_w), rel=1e-6)
    assert w[[0, 1, 3]].tolist() == [0.0, 0.0, 0.0]


def test_the_wrapper_checks_its_inputs():
    w = torch.zeros(8)
    plan = K1.plan_rows(torch.tensor([[1]]), torch.tensor([[1.0]]))
    with pytest.raises(ValueError, match="unknown loss"):
        K1.online_pass(w, torch.zeros(8), plan, torch.zeros(1), 0.1,
                       loss="hinge")
    with pytest.raises(TypeError, match="y must be"):
        K1.online_pass(w, torch.zeros(8), plan,
                       torch.zeros(1, dtype=torch.float64), 0.1)
    with pytest.raises(ValueError, match="per-example weights"):
        K1.online_pass(w, torch.zeros(8), plan, torch.zeros(1), 0.1,
                       loss="bandit")
    with pytest.raises(ValueError, match="g2"):
        K1.online_pass(w, torch.zeros(4), plan, torch.zeros(1), 0.1)


def test_use_all_reduce_raises_naming_a19():
    """use_all_reduce on a world-1 gloo mesh equals the serial fit bit
    for bit (an all-reduce of one rank, divided by 1)."""
    from torch_world1 import world1_gloo

    _, p = _hashed(_cls_cols(n=20), 10)
    serial = PL.VowpalWabbitClassifier(num_passes=2, **CPU).fit(p)
    with world1_gloo():
        meshed = PL.VowpalWabbitClassifier(use_all_reduce=True, num_passes=2,
                                           **CPU).fit(p)
    np.testing.assert_array_equal(meshed.weights, serial.weights)
    st = meshed.performance_statistics
    assert list(st["num_shards"]) == [1, 1]
    np.testing.assert_array_equal(st["average_loss"],
                                  serial.performance_statistics["average_loss"])


def test_a_jax_model_transforms_on_the_port():
    mj, _, j, p = _cls_fit(1)
    mp = PL.VowpalWabbitClassificationModel(weights=np.asarray(mj.weights),
                                            **CPU)
    np.testing.assert_allclose(mp.transform(p)["probability"],
                               mj.transform(j)["probability"], atol=1e-6)


def test_default_device_is_the_card():
    _, p = _hashed(_cls_cols(n=20), 10)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PL.VowpalWabbitClassifier().fit(p)


def _cb_cols(seed=5, n=150, num_actions=3, d=4, bits=12):
    rng = np.random.default_rng(seed)
    ctx = rng.normal(size=(n, d)).astype(np.float32)
    true_w = rng.normal(size=(num_actions, d)).astype(np.float32)
    h = JHasher(num_bits=bits)
    shared_rows = np.empty(n, dtype=object)
    action_rows = np.empty(n, dtype=object)
    chosen = np.zeros(n, np.int64)
    cost = np.zeros(n, np.float32)
    prob = rng.uniform(0.2, 0.6, size=n).astype(np.float32)
    for i in range(n):
        shared_rows[i] = (np.asarray([h("shared", "bias")], np.uint32),
                          np.ones(1, np.float32))
        acts = []
        for a in range(num_actions):
            idx = np.array([h(f"act{a}", f"x{j}") for j in range(d)],
                           np.uint32)
            acts.append((idx, ctx[i]))
        action_rows[i] = acts
        a = int(rng.integers(num_actions))
        chosen[i] = a + 1
        cost[i] = float(true_w[a] @ ctx[i]) + 0.1 * rng.normal()
    return {"shared": shared_rows, "features": action_rows,
            "chosen_action": chosen, "cost": cost, "probability": prob}


@functools.lru_cache(maxsize=None)
def _cb_fit(passes):
    cols = _cb_cols()
    kw = dict(num_passes=passes, learning_rate=0.5, num_bits=12)
    return (JCB.VowpalWabbitContextualBandit(**kw).fit(JTable(dict(cols))),
            PCB.VowpalWabbitContextualBandit(**kw, **CPU).fit(
                PTable(dict(cols))), cols)


@pytest.mark.parametrize("passes", [1, 4])
def test_contextual_bandit_weights_loss_and_metrics(passes):
    mj, mp, cols = _cb_fit(passes)
    _close_w(mj.weights, mp.weights)
    tj, tp = mj.train_metrics, mp.train_metrics
    assert set(tj) == set(tp)
    assert tp["average_loss"] == pytest.approx(tj["average_loss"], rel=1e-5)
    sj = mj.transform(JTable(dict(cols)))["prediction"]
    sp = mp.transform(PTable(dict(cols)))["prediction"]
    ties = 0
    for a, b in zip(sj, sp):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=1e-5 * max(1.0, np.abs(a).max()))
        s = np.sort(a)
        ties += int(len(s) > 1 and s[1] - s[0] < 1e-5)
    assert ties == 0
    assert tp["ips_estimate"] == pytest.approx(tj["ips_estimate"], rel=1e-6)
    assert tp["snips_estimate"] == pytest.approx(tj["snips_estimate"],
                                                 rel=1e-6)


def test_cb_metrics_math():
    m = PCB.ContextualBanditMetrics()
    m.add(True, cost=1.0, prob=0.5)
    m.add(False, cost=2.0, prob=0.5)
    assert m.ips_estimate() == pytest.approx(1.0)
    assert m.snips_estimate() == pytest.approx(1.0)
