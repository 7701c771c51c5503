"""The port's fused resize+normalize (mmlspark_tpu_torch.ops.image_kernels)
held against the JAX package's Pallas kernel
(mmlspark_tpu.ops.pallas_kernels), which runs in interpret mode on the
CPU.  Same numpy inputs on both sides.

Tolerance: atol=1e-3, rtol=1e-4 in normalized units, the reference's own
for this kernel (tests/test_image_ops.py): both sides sum the same f32
weights in a different order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.ops import pallas_kernels as P
from mmlspark_tpu_torch.ops import image_kernels as K
from mmlspark_tpu_torch.ops import image as I

torch.set_num_threads(2)

ATOL, RTOL = 1e-3, 1e-4


@pytest.mark.parametrize("dtype,shape,out_hw,c", [
    ("uint8", (2, 20, 16), (12, 10), 3),    # downscale, non-square
    ("float32", (2, 20, 16), (12, 10), 3),
    ("uint8", (3, 9, 13), (17, 11), 3),     # upscale H, downscale W
    ("float32", (1, 7, 5), (15, 12), 1),    # upscale, one channel
    ("uint8", (2, 33, 21), (8, 8), 1),      # strong downscale, one channel
    ("uint8", (2, 10, 14), (10, 14), 3),    # identity size
    ("float32", (2, 10, 14), (10, 14), 1),
])
def test_fused_resize_normalize_matches_pallas(dtype, shape, out_hw, c):
    rng = np.random.default_rng(sum(shape) + c)
    b, h, w = shape
    if dtype == "uint8":
        x = rng.integers(0, 256, size=(b, h, w, c), dtype=np.uint8)
    else:
        x = rng.uniform(0, 255, size=(b, h, w, c)).astype(np.float32)
    mean = tuple(rng.uniform(90, 130, c).round(3))
    std = tuple(rng.uniform(50, 60, c).round(3))
    ref = np.asarray(P.fused_resize_normalize(jnp.asarray(x), *out_hw, mean, std))
    got = K.fused_resize_normalize(torch.from_numpy(x), *out_hw, mean, std)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_affine_plan_channel_mix_matches_pallas():
    """The general affine contract (a colour-mixing chain) against the
    TPU kernel's `fused_affine_apply` on the same composed constants."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(2, 18, 14, 3), dtype=np.uint8)
    stages = [("resize", {"height": 11, "width": 9}),
              ("colorFormat", {"format": "bgr2gray"}),
              ("normalize", {"mean": [120.0], "std": [40.0], "scale": 1.0})]
    consts = P.build_affine_pipeline(stages, 18, 14, 3)
    plan = P.affine_plan(P.freeze_stages(stages), 18, 14, 3, itemsize=1)
    ref = np.asarray(P.fused_affine_apply(jnp.asarray(x), plan))
    got = K.affine_resample(torch.from_numpy(x), K.AffinePlan(*consts))
    assert got.shape == ref.shape == (2, 11, 9, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_resize_weights_and_taps():
    """The plan's [lo, hi) tap ranges cover every non-zero weight, and the
    weights are the JAX package's, bit for bit."""
    for n_in, n_out in [(256, 224), (320, 224), (240, 224), (7, 15), (5, 5)]:
        w = I.resize_weights(n_in, n_out)
        np.testing.assert_array_equal(w, P._resize_weights_np(n_in, n_out))
        rng = K._tap_ranges(w)
        for r in range(n_out):
            lo, hi = rng[r]
            assert not w[r, :lo].any() and not w[r, hi:].any()
    eye = K._tap_ranges(I.resize_weights(5, 5))
    np.testing.assert_array_equal(eye[:, 1] - eye[:, 0], 1)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    plan = K.resize_plan(8, 8, 3, 4, 4, (0.0,) * 3, (1.0,) * 3)
    with pytest.raises(TypeError):
        K.affine_resample(torch.zeros(1, 8, 8, 3, dtype=torch.float64), plan)
    with pytest.raises(ValueError):
        K.affine_resample(torch.zeros(1, 8, 9, 3, dtype=torch.uint8), plan)
    with pytest.raises(ValueError):
        K.affine_resample(torch.zeros(8, 8, 3, dtype=torch.uint8), plan)


def test_cpu_tensor_takes_the_plain_version():
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=(2, 12, 10, 3), dtype=np.uint8))
    before = K.LAUNCHES
    out = K.fused_resize_normalize(x, 6, 5, (1.0, 2.0, 3.0), (4.0, 5.0, 6.0))
    resized = jax.image.resize(jnp.asarray(x.numpy(), jnp.float32),
                               (2, 6, 5, 3), method="linear")
    ref = (np.asarray(resized) - np.array([1.0, 2.0, 3.0], np.float32)) \
        / np.array([4.0, 5.0, 6.0], np.float32)
    assert K.LAUNCHES == before
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
