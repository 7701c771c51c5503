"""The featurizer over a data mesh: the port's ImageFeaturizer (the
meshed TorchModel.run_grouped) on 2 gloo ranks (tests/torch_dist_worker.py,
scenario "featurizer"), held against the JAX package's ImageFeaturizer
on the same bridged ResNet-18 weights and the same table (three sizes
and a gray image, so the shape groups are ragged and chunks pad to the
data degree), with pad_to_batch off and on.  Tolerance: rtol 1e-4 and
atol 1e-4 of the largest magnitude, tests/test_torch_featurizer.py's;
every rank returns the whole column in row order, the ranks' columns
bit for bit equal; B1's plain version runs once a chunk on each rank's
rows, and each rank moves only its rows.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.models.bundle import FlaxBundle
from mmlspark_tpu.models.image_featurizer import ImageFeaturizer as JFeaturizer
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.models.torch_model import TorchModel

from torch_dist_worker import run_ranks
from torch_port_util import random_flax_variables

torch.set_num_threads(2)

HW = 32
WORLD = 2


def _images():
    rng = np.random.default_rng(5)
    sizes = [(40, 40, 3), (32, 32, 3), (48, 36, 3), (40, 40, 1)]
    order = [0, 1, 2, 0, 0, 1, 3, 2, 0, 1, 0]
    return [rng.integers(0, 256, size=sizes[k], dtype=np.uint8) for k in order]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    variables = random_flax_variables("resnet18", seed=3, hw=HW)
    jb = FlaxBundle("resnet18", {"num_classes": 10, "dtype": jnp.float32},
                    variables=variables, input_shape=(HW, HW, 3))
    tb = from_flax_variables("resnet18", variables, {"num_classes": 10},
                             input_shape=(HW, HW, 3), dtype="float32")
    images = _images()
    ids = np.arange(len(images))
    refs = {pad: np.asarray(JFeaturizer(bundle=jb, batch_size=2,
                                        pad_to_batch=pad).transform(
        JTable({"image": images, "id": ids}))["features"])
        for pad in (False, True)}
    res = run_ranks("featurizer", {"bundle": tb, "images": images,
                                   "ids": ids},
                    tmp_path_factory.mktemp("featurizer"), world=WORLD)
    return images, refs, res


@pytest.mark.parametrize("pad", [False, True])
def test_every_rank_returns_the_jax_column(run, pad):
    images, refs, res = run
    ref = refs[pad]
    scale = float(np.abs(ref).max())
    for r in range(WORLD):
        got = res[r][pad]
        np.testing.assert_array_equal(got["ids"], np.arange(len(images)))
        assert got["features"].shape == ref.shape == (len(images), 512)
        np.testing.assert_allclose(got["features"], ref, rtol=1e-4,
                                   atol=1e-4 * scale)
    np.testing.assert_array_equal(res[0][pad]["features"],
                                  res[1][pad]["features"])


@pytest.mark.parametrize("pad", [False, True])
def test_b1_runs_once_a_chunk_on_each_ranks_rows(run, pad):
    images, _refs, res = run
    groups = {}
    for i, a in enumerate(images):
        groups.setdefault(a.shape, []).append(i)
    plan, _order = TorchModel(batch_size=2, pad_to_batch=pad).chunk_plan(
        groups, WORLD)
    want = []
    for sel, shape, pad_mult in plan:
        rows = -(-len(sel) // pad_mult) * pad_mult
        want.append((rows // WORLD, shape[0], shape[1], shape[2]))
    for r in range(WORLD):
        got = res[r][pad]
        assert got["batches"] == want
        assert got["feed"]["chunks_fed"] == len(plan)
        moved = sum(int(np.prod(b)) for b in want)  # uint8: a byte a value
        assert got["feed"]["bytes_moved"] == moved


def test_without_a_group_the_single_device_path_runs():
    """A transform never starts a group: outside one, the feed is
    unmeshed and the chunks are the single-device plan's."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.models.torch_model import _data_mesh

    assert not dist.is_initialized()
    assert _data_mesh(torch.device("cpu")) is None
    assert not dist.is_initialized()
