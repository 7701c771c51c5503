"""The GBDT's data- and voting-parallel learners on 2 and 4 gloo ranks
(tests/torch_dist_worker.py, scenario "gbdt"), held against the JAX
package's Booster on a mesh of as many of the conftest's virtual CPU
devices:

  - data_parallel, dense and sparse COO: every rank's fit follows the JAX
    fit's recorded split calls by the tie rule of
    tests/torch_gbdt_compare.py (histograms within TOL = 1e-4 of the
    node's mass), its trees equal the JAX trees (structure exact, values
    within 1e-4) and its scores are within rtol 1e-4, atol 1e-5 of the
    JAX scores (tests/test_gbdt.py:216-225's tolerance);
  - voting_parallel: the per-shard histograms of `build_local` equal the
    JAX builder's within TOL, the voted mask equals JAX `vote_features`
    on the same shards exactly, and the fit's AUC is above 0.9
    (tests/test_gbdt.py:228-236);
  - `_resolve_mesh`: the world's data mesh inside a group of more than
    one rank under data_parallel, None for serial and outside a group.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from mmlspark_tpu.gbdt import Booster as JBooster, TrainConfig as JConfig
from mmlspark_tpu.gbdt import histogram as JH
from mmlspark_tpu.gbdt import tree as JT
from mmlspark_tpu.gbdt.sparse import CSRMatrix as JCSR
from mmlspark_tpu_torch.gbdt import Booster, GBDTClassifier
from mmlspark_tpu_torch.gbdt import binning as PBin
from mmlspark_tpu_torch.gbdt import histogram as PH
from mmlspark_tpu_torch.models.statistics import roc_auc

from torch_dist_worker import run_ranks
from torch_gbdt_compare import TOL, compare_fits, hist_err, recorded_splits

torch.set_num_threads(2)

WORLDS = (2, 4)
CFG = dict(objective="binary", num_iterations=6, num_leaves=15,
           min_data_in_leaf=5, seed=0)
VOTE_CFG = dict(objective="binary", num_iterations=20, num_leaves=15,
                min_data_in_leaf=5, top_k=5)
SPARSE_CFG = dict(objective="binary", num_iterations=5, num_leaves=7,
                  min_data_in_leaf=5)


def _binary_data(n=322, d=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    logit = 2.0 * x[:, 0] - 1.5 * x[:, 1] + x[:, 2] * x[:, 3]
    y = (logit + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    return x, y


def _sparse_data(n=257, f=20, density=0.15, seed=1):
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((n, f)) < density, rng.normal(size=(n, f)), 0.0)
    y = (x[:, 0] + x[:, 1] - x[:, 2] > 0).astype(np.float64)
    return x, y


def _port_calls(calls):
    """The JAX fit's recorded calls with the port's SplitInfo (picklable
    without the JAX package)."""
    return [(h, args, None if s is None else PH.SplitInfo(*s))
            for h, args, s in calls]


def _mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("data",))


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    x, y = _binary_data()
    xs, ys = _sparse_data()
    csr = JCSR.from_dense(xs)
    mapper = PBin.BinMapper(63, seed=0)
    binned = mapper.fit_transform(x)
    rng = np.random.default_rng(7)
    grad, hess = rng.normal(size=len(x)), rng.uniform(0.1, 1.0, len(x))
    out = {}
    for k in WORLDS:
        with recorded_splits(JT) as dp_calls:
            jdp = JBooster(JConfig(parallelism="data_parallel", **CFG)).fit(
                x, y, mesh=_mesh(k))
        with recorded_splits(JT) as sp_calls:
            jsp = JBooster(JConfig(parallelism="data_parallel",
                                   **SPARSE_CFG)).fit(csr, ys, mesh=_mesh(k))
        jb = JH.HistogramBuilder(binned, mapper.num_bins, mesh=_mesh(k),
                                 voting=True, top_k=5)
        g, h, w = jb.device_arrays(grad, hess, np.ones(len(x)))
        jlocal = np.asarray(jb.build_local(g, h, w, jb.node_mask(
            np.ones(len(x), bool))))
        jmask = JH.vote_features(jlocal, 0.0, 0.0, 20.0, 1e-3, 5)
        inp = {"x": x, "y": y, "cfg": CFG, "vote_cfg": VOTE_CFG,
               "dp_calls": _port_calls(dp_calls), "binned": binned,
               "num_bins": mapper.num_bins, "grad": grad, "hess": hess,
               "csr": (csr.data, csr.indices, csr.indptr, csr.shape),
               "sy": ys, "sparse_cfg": SPARSE_CFG,
               "sparse_calls": _port_calls(sp_calls)}
        res = run_ranks("gbdt", inp, tmp_path_factory.mktemp(f"gbdt{k}"),
                        world=k)
        out[k] = {"jdp": jdp, "jsp": jsp, "jlocal": jlocal, "jmask": jmask,
                  "res": res, "x": x, "y": y, "xs": xs, "csr": csr}
    return out


@pytest.mark.parametrize("k", WORLDS)
def test_data_parallel_matches_the_jax_mesh_fit(fits, k):
    f = fits[k]
    want = np.asarray(f["jdp"].score(f["x"]))
    for r in range(k):
        s, score, _ties = f["res"][r]["dp"]
        port = Booster.from_model_string(s)
        compare_fits(f["jdp"], port, label=f"data_parallel world {k}")
        np.testing.assert_allclose(score, want, rtol=1e-4, atol=1e-5)
    assert all(f["res"][r]["dp"][0] == f["res"][0]["dp"][0]
               for r in range(k)), "the ranks' trees differ"


@pytest.mark.parametrize("k", WORLDS)
def test_sparse_data_parallel_matches_the_jax_mesh_fit(fits, k):
    f = fits[k]
    want = np.asarray(f["jsp"].score(f["csr"]))
    for r in range(k):
        s, score, _ties = f["res"][r]["sparse"]
        compare_fits(f["jsp"], Booster.from_model_string(s),
                     label=f"sparse data_parallel world {k}")
        np.testing.assert_allclose(score, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k", WORLDS)
def test_voting_parallel_votes_like_jax_and_trains_well(fits, k):
    f = fits[k]
    for r in range(k):
        res = f["res"][r]
        assert res["local"].shape == f["jlocal"].shape
        for s in range(k):
            assert hist_err(res["local"][s].astype(np.float64),
                            f["jlocal"][s].astype(np.float64)) <= TOL
        np.testing.assert_array_equal(res["voted"], f["jmask"])
        s, score = res["vote"]
        auc = roc_auc(f["y"], score)
        assert auc > 0.9, f"voting AUC {auc:.4f}"
        assert s == f["res"][0]["vote"][0]


@pytest.mark.parametrize("k", WORLDS)
def test_resolve_mesh_inside_and_outside_a_group(fits, k):
    for r in range(k):
        size, serial = fits[k]["res"][r]["resolve"]
        assert size == k and serial is None
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert GBDTClassifier(parallelism="data_parallel",
                          device="cpu")._resolve_mesh() is None
