"""The port's CyberML (mmlspark_tpu_torch.cyber) held against the JAX
package's on the same inputs, made from seeds with numpy, on the CPU
(`device="cpu"`; AccessAnomaly's default is the card, and without one it
raises).

Tolerances, from the spread measured between the two packages on the
CPU:
- `_als_step_sparse` on the same factors and pairs: the row factors
  within 1e-5 of their largest (measured at most 6.9e-7; the port sums
  the observed terms in f64, the JAX package in f32).
- a fit with the JAX fit's initial factors injected (`_initial_factors`
  patched with `jax.random`'s draws): factors within 1e-4 of their
  largest and anomaly scores within 1e-4 (measured at most 7.9e-7 and
  1.8e-6 on these tables, 8 sweeps at most).
- the host stages (the complement sampler, the indexers, the scalers,
  `DataFactory`): equal, value for value — the same numpy and
  `random.Random` code.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu import Table as JTable
from mmlspark_tpu import cyber as JC
from mmlspark_tpu.cyber import access_anomaly as JA

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch import cyber as PC
from mmlspark_tpu_torch.cyber import access_anomaly as PA

from torch_tables import assert_same_table

torch.set_num_threads(2)

CPU = {"device": "cpu"}
FACTOR_RTOL, SCORE_ATOL = 1e-4, 1e-4


def access_cols(n_groups=3, users_per=8, res_per=6, events=40, seed=0):
    """Users access only their own group's resources (test_cyber.py's
    table)."""
    rng = np.random.default_rng(seed)
    rows_u, rows_r = [], []
    for g in range(n_groups):
        for _ in range(events):
            rows_u.append(g * users_per + int(rng.integers(users_per)))
            rows_r.append(g * res_per + int(rng.integers(res_per)))
    return {"user": np.asarray(rows_u, np.int64),
            "res": np.asarray(rows_r, np.int64)}


def tenants_cols():
    a, b = access_cols(seed=2), access_cols(seed=3, users_per=5)
    return {"tenant": np.concatenate([np.zeros(len(a["user"]), np.int64),
                                      np.ones(len(b["user"]), np.int64)]),
            "user": np.concatenate([a["user"], b["user"]]),
            "res": np.concatenate([a["res"], b["res"]]),
            "likelihood": np.random.default_rng(4).integers(
                1, 9, len(a["user"]) + len(b["user"])).astype(np.float64)}


def jax_initial_factors(seed, n_users, n_res, rank, device):
    """The JAX fit's draws (access_anomaly.py's PRNGKey / fold_in)."""
    key = jax.random.PRNGKey(int(seed))
    X = jax.random.normal(key, (n_users, rank), jnp.float32) * 0.1
    Y = jax.random.normal(jax.random.fold_in(key, 1), (n_res, rank),
                          jnp.float32) * 0.1
    return (torch.as_tensor(np.array(X), device=device),
            torch.as_tensor(np.array(Y), device=device))


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(PA, "_initial_factors", jax_initial_factors)


def _scale_close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("c0", [1.0, 0.5, 0.0])
def test_als_step_matches_jax(c0):
    rng = np.random.default_rng(int(c0 * 10))
    n_rows, n_cols, rank, nnz = 30, 25, 6, 200
    keys = np.unique(rng.integers(0, n_rows * n_cols, nnz))
    rows, cols = (keys // n_cols).astype(np.int32), (keys % n_cols).astype(
        np.int32)
    vals = np.log1p(rng.integers(1, 50, len(keys))).astype(np.float32)
    Y = (rng.normal(size=(n_cols, rank)) * 0.5).astype(np.float32)
    want = np.asarray(JA._als_step_sparse(
        jnp.asarray(Y), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(vals), jnp.float32(c0), jnp.float32(0.1), rank, n_rows))
    got = PA._als_step_sparse(
        torch.as_tensor(Y), torch.as_tensor(rows.astype(np.int64)),
        torch.as_tensor(cols.astype(np.int64)), torch.as_tensor(vals),
        float(np.float32(c0)), float(np.float32(0.1)), rank, n_rows)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_rows, rank)
    _scale_close(got.numpy(), want, 1e-5)


@functools.lru_cache(maxsize=None)
def _jax_fit(case):
    cols, kw = FIT_CASES[case]
    model = JC.AccessAnomaly(**kw).fit(JTable(cols()))
    return model, model.transform(JTable(cols()))


FIT_CASES = {
    "one_tenant": (access_cols, dict(rank=6, max_iter=8, seed=1)),
    "tenants_likelihood": (tenants_cols, dict(
        tenant_col="tenant", likelihood_col="likelihood", rank=4,
        max_iter=5, seed=3)),
    "complement_half": (access_cols, dict(rank=3, max_iter=4,
                                          complement_ratio=0.5, seed=2)),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_matches_jax_from_its_initial_factors(case, jax_draws):
    jmodel, want = _jax_fit(case)
    cols, kw = FIT_CASES[case]
    model = PC.AccessAnomaly(**kw, **CPU).fit(Table(cols()))
    assert set(model.factors) == set(jmodel.factors)
    for t in jmodel.factors:
        for got, ref in zip(model.factors[t], jmodel.factors[t]):
            assert got.dtype == np.float32 and got.shape == ref.shape
            _scale_close(got, np.asarray(ref), FACTOR_RTOL)
        np.testing.assert_allclose(model.stats[t], jmodel.stats[t],
                                   rtol=1e-4, atol=1e-6)
    out = model.transform(Table(cols()))
    np.testing.assert_allclose(out["anomaly_score"], want["anomaly_score"],
                               rtol=0, atol=SCORE_ATOL)


def test_a_jax_fitted_model_scores_on_the_port():
    jmodel, want = _jax_fit("tenants_likelihood")
    model = PC.AccessAnomalyModel(
        factors=jmodel.factors, stats=jmodel.stats, tenant_col="tenant")
    got = model.transform(Table(tenants_cols()))
    np.testing.assert_array_equal(got["anomaly_score"], want["anomaly_score"])


def test_initial_factors_are_seeded_and_device_free():
    a = PA._initial_factors(5, 7, 4, 3, torch.device("cpu"))
    b = PA._initial_factors(5, 7, 4, 3, torch.device("cpu"))
    for x, y in zip(a, b):
        assert torch.equal(x, y) and x.dtype == torch.float32
    assert tuple(a[0].shape) == (7, 3) and tuple(a[1].shape) == (4, 3)
    assert 0.05 < float(a[0].std()) < 0.2


def test_access_anomaly_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PC.AccessAnomaly(rank=3, max_iter=1).fit(Table(access_cols()))
    assert PC.AccessAnomaly(rank=3, max_iter=1, **CPU).fit(
        Table(access_cols())).factors


COMPLEMENT_CASES = {
    "sparse": lambda: access_cols(n_groups=1, users_per=5, res_per=5,
                                  events=10, seed=4),
    "tenants": lambda: {k: v for k, v in tenants_cols().items()
                        if k != "likelihood"},
    "dense_grid": lambda: {
        "user": np.meshgrid(np.arange(10), np.arange(10))[0].ravel()[
            np.setdiff1d(np.arange(100), [5, 37, 61, 88])].astype(np.int64),
        "res": np.meshgrid(np.arange(10), np.arange(10))[1].ravel()[
            np.setdiff1d(np.arange(100), [5, 37, 61, 88])].astype(np.int64)},
    "exhausted": lambda: {"user": np.asarray([0, 0, 1, 1], np.int64),
                          "res": np.asarray([0, 1, 0, 1], np.int64)},
}


@pytest.mark.parametrize("case", sorted(COMPLEMENT_CASES))
def test_complement_sampler_equals_jax(case):
    cols = COMPLEMENT_CASES[case]()
    kw = dict(complement_ratio=2.0 if case == "exhausted" else 1.0, seed=9)
    if case == "tenants":
        kw["tenant_col"] = "tenant"
    got = PC.ComplementAccessTransformer(**kw).transform(Table(cols))
    want = JC.ComplementAccessTransformer(**kw).transform(JTable(cols))
    assert_same_table(want, got)
    def pairs(c):
        ten = c["tenant"] if "tenant_col" in kw else np.zeros(len(c["user"]))
        return set(zip(np.asarray(ten).tolist(), c["user"].tolist(),
                       c["res"].tolist()))

    assert not pairs(cols) & pairs({k: got[k] for k in got.column_names})


def test_indexers_and_scalers_equal_jax():
    rng = np.random.default_rng(12)
    cols = {"tenant": rng.integers(0, 3, 40).astype(np.int64),
            "user": np.asarray([f"u{i}" for i in rng.integers(0, 9, 40)],
                               object),
            "value": rng.normal(size=40) * 5 + 2}
    probe = dict(cols, user=np.asarray(
        list(cols["user"][:-3]) + ["new0", "new1", "u1"], object))
    for name, kw in (("IdIndexer", dict(input_col="user",
                                        partition_key="tenant",
                                        output_col="uidx")),
                     ("PartitionedStandardScaler", dict(
                         input_col="value", partition_key="tenant",
                         output_col="scaled")),
                     ("PartitionedMinMaxScaler", dict(input_col="value",
                                                      output_col="scaled"))):
        pm = getattr(PC, name)(**kw).fit(Table(cols))
        jm = getattr(JC, name)(**kw).fit(JTable(cols))
        assert_same_table(jm.transform(JTable(probe)),
                          pm.transform(Table(probe)))
        assert type(pm).__name__ == type(jm).__name__
    assert pm.stats == jm.stats


def test_data_factory_tables_equal_jax():
    for kw in ({}, {"num_hr_users": 4, "num_eng_resources": 12, "seed": 7,
                    "single_component": False}):
        p, j = PC.DataFactory(**kw), JC.DataFactory(**kw)
        train_p = p.create_clustered_training_data(ratio=0.4)
        train_j = j.create_clustered_training_data(ratio=0.4)
        assert_same_table(train_j, train_p)
        assert_same_table(j.create_clustered_intra_test_data(train_j),
                          p.create_clustered_intra_test_data(train_p))
        assert_same_table(j.create_clustered_inter_test_data(),
                          p.create_clustered_inter_test_data())


# ---- the JAX package's own checks, on the port ---------------------------

def test_cross_group_access_scores_higher():
    model = PC.AccessAnomaly(rank=6, max_iter=8, seed=1, **CPU).fit(
        Table(access_cols()))
    users = np.asarray([0, 1, 9, 17], np.int64)
    s_in = model.transform(Table({"user": users, "res": np.asarray(
        [0, 3, 7, 13], np.int64)}))["anomaly_score"]
    s_cross = model.transform(Table({"user": users, "res": np.asarray(
        [13, 16, 1, 2], np.int64)}))["anomaly_score"]
    assert s_cross.mean() > s_in.mean() + 0.5, (s_in, s_cross)


def test_data_factory_anomaly_separation():
    fac = PC.DataFactory(seed=42)
    train = fac.create_clustered_training_data(ratio=0.4)
    intra = fac.create_clustered_intra_test_data(train)
    inter = fac.create_clustered_inter_test_data()
    user_ix = PC.IdIndexer(input_col="user_id", output_col="user").fit(train)
    res_ix = PC.IdIndexer(input_col="res_id", output_col="res").fit(train)

    def index(t):
        return res_ix.transform(user_ix.transform(t))

    model = PC.AccessAnomaly(rank=6, max_iter=8, seed=0,
                             likelihood_col="likelihood", **CPU).fit(
                                 index(train))

    def scores(t):
        idx = index(t)
        keep = (np.asarray(idx["user"]) >= 0) & (np.asarray(idx["res"]) >= 0)
        return np.asarray(model.transform(idx.filter(keep))["anomaly_score"])

    s_intra, s_inter = scores(intra), scores(inter)
    assert float(np.mean(s_inter)) > float(np.mean(s_intra)) + 0.5


def test_cyber_roundtrip():
    from torch_fuzzing import fuzz

    fuzz(PC.AccessAnomaly(rank=3, max_iter=3, **CPU),
         Table(access_cols(n_groups=2, users_per=4, res_per=4, events=15,
                           seed=6)))
