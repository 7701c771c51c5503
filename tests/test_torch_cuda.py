"""Tests of mmlspark_tpu_torch that need a CUDA card: each kernel against
its plain PyTorch version on the card, and the featurizer's card path.
They skip without a card (the kernels have no CPU mode).  This file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: atol=1e-3, rtol=1e-4 in normalized units, as for the kernel's
CPU parity test against the JAX package (test_torch_image_kernels.py).
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.models.bundle import (TorchBundle, get_builder,
                                              init_state_dict)
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.ops import image_kernels as K

torch.set_num_threads(2)

ATOL, RTOL = 1e-3, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,out_hw", [
    ("uint8", (4, 256, 256, 3), (224, 224)),
    ("uint8", (4, 320, 240, 3), (224, 224)),
    ("uint8", (3, 224, 224, 3), (224, 224)),
    ("float32", (2, 37, 53, 1), (224, 224)),
    ("uint8", (2, 19, 23, 4), (7, 31)),
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, shape, out_hw):
    rng = np.random.default_rng(1)
    if dtype == "uint8":
        x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    else:
        x = rng.uniform(0, 255, size=shape).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda_device)
    c = shape[3]
    plan = K.resize_plan(shape[1], shape[2], c, *out_hw,
                         (100.0,) * c, (50.0,) * c)
    before = K.LAUNCHES
    got = K.affine_resample(xt, plan)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    ref = K.affine_resample_plain(xt, plan)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_kernel_rejects_a_strided_batch(cuda_device):
    x = torch.zeros(2, 8, 8, 4, dtype=torch.uint8, device=cuda_device)
    plan = K.resize_plan(8, 8, 3, 4, 4, (0.0,) * 3, (1.0,) * 3)
    with pytest.raises(ValueError):
        K.affine_resample(x[..., :3], plan)


@pytest.mark.cuda
def test_featurizer_on_card_launches_the_kernel_per_chunk(cuda_device):
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=s, dtype=np.uint8)
              for s in [(40, 40, 3), (32, 32, 3), (40, 40, 3), (48, 36, 1),
                        (40, 40, 3)]]
    # random BatchNorms: under flax's init every residual branch is 0 and
    # the check would see only the stem and the projection convs
    state = init_state_dict(get_builder("resnet18")(num_classes=10), seed=0,
                            random_bn=True)
    bundle = TorchBundle("resnet18", {"num_classes": 10}, state_dict=state,
                         input_shape=(32, 32, 3), dtype="float32")
    K.LAUNCHES = 0
    got = ImageFeaturizer(bundle=bundle, batch_size=2).transform(
        Table({"image": images}))["features"]
    # chunks: 40x40 group of 3 -> 2 chunks, 32x32 -> 1, gray 48x36 -> 1
    assert K.LAUNCHES == 4
    ref = ImageFeaturizer(bundle=bundle, batch_size=2, device="cpu").transform(
        Table({"image": images}))["features"]
    assert got.shape == ref.shape == (5, 512)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3 * scale)
