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


# B1's tile route (csrc/resize_normalize.cu): the host's tile tables, its
# route rule and its rows-a-tile rule, checked here since the kernel runs
# only on the card.
def _chain_plans():
    """A resize, a crop + resize, a flip, a blur chain and an upscale."""
    chains = {
        "resize": [("resize", {"height": 224, "width": 224})],
        "crop_resize": [("crop", {"x": 9, "y": 17, "height": 150,
                                  "width": 140}),
                        ("resize", {"height": 64, "width": 48})],
        "flip": [("resize", {"height": 70, "width": 90}),
                 ("flip", {"flipLeftRight": True, "flipUpDown": True})],
        "blur": [("resize", {"height": 120, "width": 100}),
                 ("centerCrop", {"height": 96, "width": 96}),
                 ("blur", {"height": 3.0, "width": 3.0}), ("flip", {})],
        "upscale": [("resize", {"height": 301, "width": 257})],
    }
    return {name: K.affine_plan(K.freeze_stages(st), 256, 200, 3)
            for name, st in chains.items()}


@pytest.mark.parametrize("name", ["resize", "crop_resize", "flip", "blur",
                                  "upscale"])
def test_tile_spans_hold_every_tap_of_their_rows(name):
    plan = _chain_plans()[name]
    for ty in sorted({1, 3, 7, 16, plan.h_out,
                      plan.tiling(torch.uint8, 64)[0]}):
        table = plan.tile_table(ty)
        assert table.shape == (-(-plan.h_out // ty), 2)
        assert table.dtype == np.int32
        for y in range(plan.h_out):
            lo, hi = table[y // ty]
            taps = np.flatnonzero(plan.a_h[y])
            assert taps.size and lo <= taps.min() and taps.max() < hi, (y, ty)
        # no wider than the tap ranges of the tile's rows
        for t, (lo, hi) in enumerate(table):
            rows = plan.y_rng[t * ty:(t + 1) * ty]
            assert lo == rows[:, 0].min() and hi == rows[:, 1].max()


@pytest.mark.parametrize("name", ["resize", "crop_resize", "flip", "blur",
                                  "upscale"])
def test_compacted_width_taps_are_the_weights(name):
    """Each column's k_w taps from x_lo lie in the row and hold every
    non-zero weight of a_w, so summing them is summing the row."""
    plan = _chain_plans()[name]
    assert (plan.x_lo >= 0).all() and (plan.x_lo + plan.k_w <= plan.w_in).all()
    for x in range(plan.w_out):
        dense = np.zeros(plan.w_in, np.float32)
        dense[plan.x_lo[x]:plan.x_lo[x] + plan.k_w] = plan.w_taps[x]
        np.testing.assert_array_equal(dense, plan.a_w[x])


def _tile_route_numpy(x, plan, ty):
    """The tile route's arithmetic in numpy, in f32, from the plan's
    tables: per tile, its span's rows, the width taps from x_lo, the
    channel mix, then the height taps over the span and the epilogue."""
    b = x.shape[0]
    out = np.empty((b, plan.h_out, plan.w_out, plan.c_out), np.float32)
    xf = x.astype(np.float32)
    cols = plan.x_lo[:, None] + np.arange(plan.k_w)[None, :]
    for t, (lo, hi) in enumerate(plan.tile_table(ty)):
        span = xf[:, lo:hi]                              # [b, span, w_in, c]
        wide = np.einsum("xk,bsxkc->bsxc", plan.w_taps, span[:, :, cols])
        mixed = np.einsum("bsxc,cd->bsxd", wide, plan.cmix)
        ys = slice(t * ty, min((t + 1) * ty, plan.h_out))
        u = np.einsum("ys,bsxd->byxd", plan.a_h[ys, lo:hi], mixed)
        out[:, ys] = (u - plan.mean_eff) * plan.inv_eff
    return out


@pytest.mark.parametrize("name", ["resize", "crop_resize", "flip", "blur",
                                  "upscale"])
def test_tile_route_tables_reproduce_the_plain_version(name):
    plan = _chain_plans()[name]
    x = np.random.default_rng(5).integers(0, 256, (2, 256, 200, 3),
                                          dtype=np.uint8)
    ref = K.affine_resample_plain(torch.from_numpy(x), plan).numpy()
    for ty in (1, 5, plan.tiling(torch.uint8, 2)[0]):
        np.testing.assert_allclose(_tile_route_numpy(x, plan, ty), ref,
                                   atol=ATOL, rtol=RTOL)


def _f32_plan(w_in):
    return K.resize_plan(600, w_in, 3, 224, 224, (0.0,) * 3, (1.0,) * 3)


def test_route_rule_on_both_sides_of_its_limit():
    """A plan takes the tile route for an input type when one output
    row's span fits TILE_SMEM; the f32 input's width where it stops."""
    lo, hi = 256, 4096              # tile at lo, pixel at hi
    assert _f32_plan(lo).route["float32"] == "tile"
    assert _f32_plan(hi).route["float32"] == "pixel"
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _f32_plan(mid).route["float32"] == "tile":
            lo = mid
        else:
            hi = mid
    fits, over = _f32_plan(lo), _f32_plan(hi)
    ty, span = fits.tiling(torch.float32, 8)
    assert fits.tile_smem(span, 4, ty) <= K.TILE_SMEM < \
        over.tile_smem(over._span(1), 4, 1)
    assert over.tiling(torch.float32, 8) == (0, 0)     # the pixel route
    # the same plan's uint8 rows are a quarter of the bytes: still tiles
    assert over.route["uint8"] == "tile"


@pytest.mark.parametrize("w_in,route", [(128, "tile"), (130, "pixel")])
def test_route_rule_holds_a_columns_width_taps_in_registers(w_in, route):
    """A narrow strip downscaled 4 to 1 and more: small spans, but more
    width taps a column than TILE_MAX_TAPS past its limit."""
    plan = K.resize_plan(8, w_in, 3, 8, 16, (0.0,) * 3, (1.0,) * 3)
    assert (plan.k_w <= K.TILE_MAX_TAPS) == (route == "tile")
    assert plan.tile_smem(plan._span(1), 4, 1) <= K.TILE_SMEM
    assert plan.route == {"uint8": route, "float32": route}


@pytest.mark.parametrize("shape,n,ty", [
    ((256, 256), 64, 16), ((224, 224), 64, 21), ((320, 240), 64, 13),
    ((32, 32), 256, 32), ((32, 32), 64, 11)])
def test_rows_a_tile_rule_at_the_main_shapes(shape, n, ty):
    """The fewest balanced tiles that give each of 132 SMs a block and fit
    three blocks an SM: pinned at the featurizers' and
    DeepVisionClassifier's chunk shapes."""
    out = 224 if shape[0] > 32 else 32
    plan = K.resize_plan(*shape, 3, out, out, (0.0,) * 3, (1.0,) * 3)
    got, span = plan.tiling(torch.uint8, n)
    assert got == ty and span == plan._span(ty)
    tiles = -(-out // ty)
    assert n * tiles >= K.TILE_MIN_BLOCKS
    assert plan.tile_smem(span, 1, ty) <= K.TILE_SMEM
    if tiles > 1:  # one tile fewer is more rows a tile: it does not fit
        wider = -(-out // (tiles - 1))
        assert n * (tiles - 1) < K.TILE_MIN_BLOCKS or \
            plan.tile_smem(plan._span(wider), 1, wider) > K.TILE_SMEM
    assert plan.tiling(torch.uint8, 0)[0] >= 1  # an empty batch: no error
