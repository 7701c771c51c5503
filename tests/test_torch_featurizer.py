"""The slice end to end: the port's ImageFeaturizer (device="cpu") held
against the JAX package's ImageFeaturizer on the same bridged ResNet-18
weights and the same table of uint8 BGR arrays — three sizes, one gray
image, a batch size smaller than a group (so chunks are padded), with
pad_to_batch off and on.  Both sides run f32; the features agree within
1e-4 of their largest magnitude (the f32 tolerance of
test_torch_resnet.py; the observed gap is about 1e-6: the frameworks sum
the resize weights and the convolutions in another order), and rows keep
their order.

Also here: the entry points' device default (cuda, or raise), the
stage registry of the port, and the DeviceFeed/TorchModel host path.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.models.bundle import FlaxBundle
from mmlspark_tpu.models.image_featurizer import ImageFeaturizer as JFeaturizer
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.core import registry
from mmlspark_tpu_torch.io.feed import FEED_TELEMETRY, DeviceFeed
from mmlspark_tpu_torch.models.bundle import TorchBundle, from_flax_variables
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models.torch_model import TorchModel, pad_to_multiple
from mmlspark_tpu_torch.ops import image_kernels as K

from torch_port_util import random_flax_variables

torch.set_num_threads(2)

HW = 32


def _images():
    rng = np.random.default_rng(5)
    sizes = [(40, 40, 3), (32, 32, 3), (48, 36, 3), (40, 40, 1)]
    order = [0, 1, 2, 0, 0, 1, 3, 2, 0, 1, 0]
    return [rng.integers(0, 256, size=sizes[k], dtype=np.uint8) for k in order]


@pytest.fixture(scope="module")
def bundles():
    variables = random_flax_variables("resnet18", seed=3, hw=HW)
    jb = FlaxBundle("resnet18", {"num_classes": 10, "dtype": jnp.float32},
                    variables=variables, input_shape=(HW, HW, 3))
    tb = from_flax_variables("resnet18", variables, {"num_classes": 10},
                             input_shape=(HW, HW, 3), dtype="float32")
    return jb, tb


@pytest.mark.parametrize("pad_to_batch", [False, True])
def test_featurizer_matches_jax(bundles, pad_to_batch):
    jb, tb = bundles
    images = _images()
    ids = np.arange(len(images))
    ref = JFeaturizer(bundle=jb, batch_size=2, pad_to_batch=pad_to_batch
                      ).transform(JTable({"image": images, "id": ids}))
    before = K.LAUNCHES
    got = ImageFeaturizer(bundle=tb, batch_size=2, pad_to_batch=pad_to_batch,
                          device="cpu").transform(
                              Table({"image": images, "id": ids}))
    assert K.LAUNCHES == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(got["id"], ids)
    f_got, f_ref = got["features"], np.asarray(ref["features"])
    assert f_got.shape == f_ref.shape == (len(images), 512)
    assert f_got.dtype == np.float32
    scale = float(np.abs(f_ref).max())
    np.testing.assert_allclose(f_got, f_ref, rtol=1e-4, atol=1e-4 * scale)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tb = TorchBundle("resnet18", {"num_classes": 10}, input_shape=(HW, HW, 3))
    table = Table({"image": _images()[:2]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImageFeaturizer(bundle=tb).transform(table)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImageFeaturizer(bundle=tb, device="cuda").transform(table)
    feats = Table({"features": np.zeros((2, HW, HW, 3), np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchModel(bundle=tb, input_col="features").transform(feats)
    out = TorchModel(bundle=tb, input_col="features", device="cpu",
                     fetch_node="pool").transform(feats)
    assert out["output"].shape == (2, 512)


def test_jpeg_bytes_column_is_not_ported_yet(bundles):
    """A mostly-JPEG bytes column whose one JPEG is not decodable: the
    port takes the JAX package's fast path and, like it, drops the row
    (the name is kept from when the port refused such a column)."""
    jb, tb = bundles
    cells = [b"\xff\xd8\xff\xe0 not a real jpeg", None]
    ref = JFeaturizer(bundle=jb).transform(JTable({"image": cells}))
    got = ImageFeaturizer(bundle=tb, device="cpu").transform(
        Table({"image": cells}))
    assert got.num_rows == ref.num_rows == 0
    assert got["features"].shape == np.asarray(ref["features"]).shape == (0,)


def test_port_has_its_own_stage_registry():
    stages = registry.all_stages()
    assert stages["ImageFeaturizer"] is ImageFeaturizer
    assert stages["TorchModel"] is TorchModel
    assert all(c.__module__.startswith("mmlspark_tpu_torch.")
               for c in stages.values())


def test_chunk_plan_and_padding_follow_the_reference():
    m = TorchModel(batch_size=4)
    plan, order = m.chunk_plan({(8, 8): [0, 2, 4, 6, 7], (4, 4): [1, 3]})
    assert [(sel, pad) for sel, _shape, pad in plan] == [
        ([0, 2, 4, 6], 4), ([7], 4), ([1, 3], 1)]
    assert order == [0, 2, 4, 6, 7, 1, 3]
    m.set(pad_to_batch=True)
    assert m.chunk_sizes(2) == (4, 4)
    arr, n = pad_to_multiple(np.arange(3)[:, None], 4)
    assert n == 3 and arr[:, 0].tolist() == [0, 1, 2, 2]


def test_device_feed_cpu_path_keeps_order_and_counts():
    before = FEED_TELEMETRY.snapshot()
    chunks = [(np.full((4, 2), i, np.uint8), 3 if i == 2 else 4)
              for i in range(3)]
    # coalesce=1: one copy a chunk (the default packs ready chunks)
    outs = DeviceFeed(torch.device("cpu"), depth=2, coalesce=1).run(
        iter(chunks), lambda x: x.float() * 2)
    assert [o.shape for o in outs] == [(4, 2), (4, 2), (3, 2)]
    assert [float(o[0, 0]) for o in outs] == [0.0, 2.0, 4.0]
    d = FEED_TELEMETRY.delta(before)
    assert d["transfer_calls"] == 3 and d["chunks_fed"] == 3
    assert d["bytes_moved"] == 3 * 8


def test_host_pipeline_feed_keeps_order_under_contention():
    """More assembly workers than cores, a short switch interval and
    jittered work: every chunk reaches the feed once, in plan order."""
    import sys
    import time

    from mmlspark_tpu_torch.io.pipeline import HostPipeline, PipelineStage

    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 0.002, size=64)

    def assemble(i):
        time.sleep(delays[i])
        return np.full((2, 3), i, np.int32), 2

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t0 = time.perf_counter()
        pipe = HostPipeline([PipelineStage("assemble", assemble, workers=16)])
        outs = DeviceFeed(torch.device("cpu"), depth=3).run(
            pipe.feed_source(range(64)), lambda x: x * 1)
        assert time.perf_counter() - t0 < 30
    finally:
        sys.setswitchinterval(old)
    assert [int(o[0, 0]) for o in outs] == list(range(64))
