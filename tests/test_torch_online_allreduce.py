"""The online learners' `use_all_reduce` on 2 and 4 gloo ranks
(tests/torch_dist_worker.py, scenario "online"): each rank's block of
rows through K1's plain loop, then the end-of-pass mean of w and g2 and
sum of the loss, held against the JAX package's `_allreduce_pass` fit on
a mesh of as many virtual CPU devices (its MeshContext).  Weights within
W_TOL = 1e-5 of max |w| (tests/test_torch_online_learners.py), per-pass
losses within 1e-5 relative, every rank's weights bit for bit equal, and
`num_shards` the data degree.  The row counts are not multiples of 4, so
the all-zero padding rows are exercised.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.online import VowpalWabbitFeaturizer as JFeat
from mmlspark_tpu.online import learners as JL
from mmlspark_tpu.parallel.mesh import MeshContext
from mmlspark_tpu_torch import Table as PTable
from mmlspark_tpu_torch.online import VowpalWabbitFeaturizer as PFeat

from torch_dist_worker import run_ranks

torch.set_num_threads(2)

WORLDS = (2, 4)
W_TOL = 1e-5
PASSES = 3


def _vec_rows(x):
    rows = np.empty(len(x), dtype=object)
    for i in range(len(x)):
        rows[i] = x[i]
    return rows


def _tables(n, seed, bits, regression):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    if regression:
        y = x @ np.array([1.0, -2.0, 0.5, 0.0, 0.3], np.float32)
    else:
        y = (x[:, 0] - 2 * x[:, 1] + 0.5 * rng.normal(size=n) > 0
             ).astype(np.int64)
    cols = {"vec": _vec_rows(x), "label": y}
    j = JFeat(input_cols=["vec"], num_bits=bits).transform(JTable(dict(cols)))
    p = PFeat(input_cols=["vec"], num_bits=bits).transform(PTable(dict(cols)))
    return j, p


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    jc, pc = _tables(203, 0, 12, False)
    jr, pr = _tables(151, 3, 11, True)
    out = {}
    for k in WORLDS:
        with MeshContext(Mesh(np.array(jax.devices()[:k]), ("data",))):
            refs = {
                "cls": JL.VowpalWabbitClassifier(
                    use_all_reduce=True, num_passes=PASSES).fit(jc),
                "reg": JL.VowpalWabbitRegressor(
                    use_all_reduce=True, num_passes=PASSES).fit(jr)}
        res = run_ranks("online", {"cls": pc, "reg": pr, "passes": PASSES},
                        tmp_path_factory.mktemp(f"online{k}"), world=k)
        out[k] = (refs, res)
    return out


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("which", ["cls", "reg"])
def test_all_reduce_fit_matches_the_jax_mesh_fit(fits, k, which):
    refs, res = fits[k]
    ref = refs[which]
    wj = np.asarray(ref.weights)
    st = ref.performance_statistics
    for r in range(k):
        w, shards, losses = res[r][which]
        scale = max(float(np.abs(wj).max()), 1e-6)
        assert float(np.abs(np.asarray(w) - wj).max()) / scale <= W_TOL
        np.testing.assert_allclose(losses, np.asarray(st["average_loss"]),
                                   rtol=1e-5)
        assert shards == [k] * PASSES == list(st["num_shards"])
        np.testing.assert_array_equal(w, res[0][which][0])
