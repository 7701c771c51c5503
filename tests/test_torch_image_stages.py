"""The port's image stages (mmlspark_tpu_torch.ops.image_stages), their
eager ops (ops/image.py), the affine-chain planner and the fused
normalize+unroll (ops/image_kernels.py), held against the JAX package on
the same numpy inputs, all on the CPU (device="cpu").

Tolerances:
  - the eager ops 1e-5 abs on inputs in [0, 1): both sides compute in
    f32, in another summation order (observed <= 1e-6);
  - `build_affine_pipeline`'s constants 1e-6 abs: both compose the same
    f64 matrices and round them to f32 once;
  - ImageTransformer rows at test_fused_pipeline.py's limits: uint8 rows
    within 1 LSB (a float result straddling a truncation threshold),
    float rows rtol 1e-4 / atol 1e-2;
  - the unroll 1e-6 abs, the JAX package's own limit for it
    (tests/test_image_ops.py); the stages built on resize 1e-4;
  - UnrollImage -> TorchModel(ResNet-18) against UnrollImage -> TPUModel
    rtol 1e-4 / atol 1e-4 of the largest feature, as
    test_torch_featurizer.py.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.io.image import array_to_image_row as j_row
from mmlspark_tpu.io.image import encode_image_row
from mmlspark_tpu.models.bundle import FlaxBundle
from mmlspark_tpu.models.tpu_model import TPUModel
from mmlspark_tpu.ops import image as JI
from mmlspark_tpu.ops import image_stages as JS
from mmlspark_tpu.ops import pallas_kernels as P
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.core import registry
from mmlspark_tpu_torch.io.image import array_to_image_row
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.ops import image as I
from mmlspark_tpu_torch.ops import image_kernels as K
from mmlspark_tpu_torch.ops import image_stages as S

from torch_port_util import random_flax_variables

torch.set_num_threads(2)

OP_ATOL = 1e-5

_X = np.random.default_rng(0).random((2, 13, 10, 3)).astype(np.float32)

OPS = [
    pytest.param(lambda m, b: m.resize(b, 7, 6, "linear"), id="resize-linear-down"),
    pytest.param(lambda m, b: m.resize(b, 20, 17, "linear"), id="resize-linear-up"),
    pytest.param(lambda m, b: m.resize(b, 6, 5, "cubic"), id="resize-cubic-down"),
    pytest.param(lambda m, b: m.resize(b, 19, 23, "cubic"), id="resize-cubic-up"),
    pytest.param(lambda m, b: m.resize(b, 5, 7, "nearest"), id="resize-nearest-down"),
    pytest.param(lambda m, b: m.resize(b, 29, 21, "nearest"), id="resize-nearest-up"),
    pytest.param(lambda m, b: m.resize(b, 13, 4, "cubic"), id="resize-one-axis"),
    pytest.param(lambda m, b: m.crop(b, 2, 3, 5, 6), id="crop"),
    pytest.param(lambda m, b: m.center_crop(b, 8, 7), id="center-crop"),
    pytest.param(lambda m, b: m.flip(b, True, True), id="flip-both"),
    pytest.param(lambda m, b: m.flip(b, False, True), id="flip-ud"),
    pytest.param(lambda m, b: m.box_blur(b, 2, 2), id="box-blur-even"),
    pytest.param(lambda m, b: m.box_blur(b, 3, 4), id="box-blur-mixed"),
    pytest.param(lambda m, b: m.gaussian_blur(b, 4, 1.3), id="gauss-even"),
    pytest.param(lambda m, b: m.gaussian_blur(b, 5, 0.0), id="gauss-odd-auto-sigma"),
    pytest.param(lambda m, b: m.normalize(b, [0.2, 0.4, 0.6], [0.5, 0.25, 2.0], 3.0),
                 id="normalize-scale"),
    pytest.param(lambda m, b: m.normalize(b, [0.5], [0.3]), id="normalize-broadcast"),
    pytest.param(lambda m, b: m.hwc_to_chw_flat(b), id="hwc-to-chw-flat"),
    pytest.param(lambda m, b: m.chw_flat_to_hwc(m.hwc_to_chw_flat(b), 13, 10, 3),
                 id="chw-flat-to-hwc"),
] + [pytest.param(functools.partial(lambda mode, m, b: m.color_convert(b, mode), mode),
                  id=f"color-{mode}")
     for mode in ("bgr2rgb", "rgb2bgr", "bgr2gray", "rgb2gray")] + [
    pytest.param(lambda m, b: m.color_convert(b[..., :1], "gray2bgr"), id="color-gray2bgr"),
] + [pytest.param(functools.partial(lambda kind, m, b: m.threshold(b, 0.4, 0.9, kind), kind),
                  id=f"threshold-{kind}")
     for kind in ("binary", "binary_inv", "trunc", "tozero", "tozero_inv")]


@pytest.mark.parametrize("op", OPS)
def test_eager_op_matches_jax(op):
    ref = np.asarray(op(JI, jnp.asarray(_X)))
    got = op(I, torch.from_numpy(_X))
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=OP_ATOL, rtol=0)


def test_gaussian_kernel_and_unknown_modes():
    np.testing.assert_allclose(I.gaussian_kernel(6, 0.0),
                               JI.gaussian_kernel(6, 0.0), atol=1e-7, rtol=0)
    b = torch.zeros(1, 2, 2, 3)
    with pytest.raises(ValueError):
        I.color_convert(b, "hsv")
    with pytest.raises(ValueError):
        I.threshold(b, 1.0, 2.0, "otsu")
    with pytest.raises(ValueError):
        I.resize(b, 3, 3, "lanczos3")


AFFINE_CHAINS = [
    [("resize", dict(height=16, width=12)),
     ("normalize", dict(mean=[1.0, 2.0, 3.0], std=[4.0, 5.0, 6.0]))],
    [("crop", dict(x=2, y=3, width=14, height=16)),
     ("blur", dict(height=2, width=3)), ("flip", dict(flipUpDown=True))],
    [("gaussianKernel", dict(apertureSize=4, sigma=1.2)),
     ("centerCrop", dict(height=16, width=10)),
     ("colorFormat", dict(format="bgr2gray")),
     ("normalize", dict(mean=[0.5], std=[2.0], scale=0.5))],
    [("resize", dict(height=30, width=9)),
     ("colorFormat", dict(format="rgb2bgr"))],
]


@pytest.mark.parametrize("chain", AFFINE_CHAINS, ids=range(len(AFFINE_CHAINS)))
def test_affine_constants_match_jax(chain):
    got = K.build_affine_pipeline(chain, 24, 20, 3)
    ref = P.build_affine_pipeline(chain, 24, 20, 3)
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("chain", [
    [("threshold", dict(threshold=10, maxVal=255)),
     ("resize", dict(height=4, width=4))],                 # non-linear op
    [("normalize", dict(mean=[0.0], std=[1.0])),
     ("resize", dict(height=4, width=4))],                 # op after normalize
    [("resize", dict(height=4, width=4, method="nearest"))],
    [("resize", dict(height=4, width=4)), ("sharpen", {})],  # unknown op
    [("resize", dict(height=4, width=4)),
     ("normalize", dict(mean=[10.0], std=[2.0], scale=0.0))],
    [("flip", dict(flipLeftRight=True))],                  # view-only chains
    [("crop", dict(x=1, y=1, width=4, height=4)),
     ("colorFormat", dict(format="bgr2rgb"))],
    [("resize", dict(height=8, width=8))],                 # identity size
    [("colorFormat", dict(format="gray2bgr")),
     ("blur", dict(height=3, width=3))],                   # channel mismatch
], ids=["threshold", "after-normalize", "nearest", "unknown", "zero-scale",
        "flip", "crop-swap", "identity", "channels"])
def test_affine_pipeline_declines_as_jax_does(chain):
    assert P.build_affine_pipeline(chain, 8, 8, 3) is None
    assert K.build_affine_pipeline(chain, 8, 8, 3) is None
    assert K.affine_plan(K.freeze_stages(chain), 8, 8, 3) is None


# ---- the stages --------------------------------------------------------

def _images(c=3, n=3, h=24, w=20, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (h, w, c) if c > 1 else (h, w)).astype(np.uint8)
            for _ in range(n)]


def _tables(arrays):
    rows = [j_row(a) for a in arrays]
    return (JTable({"image": rows}),
            Table({"image": [array_to_image_row(a) for a in arrays]}))


def _build(mod, stages, fuse, **kw):
    t = mod.ImageTransformer(output_col="out", fuse=fuse, **kw)
    for name, args in stages:
        t._add(name, **args)
    return t


def _assert_rows_close(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        uint8_row = isinstance(b, dict)
        assert isinstance(a, dict) == uint8_row
        fa = a["data"] if uint8_row else a
        fb = b["data"] if uint8_row else b
        assert np.shape(fa) == np.shape(fb)
        assert np.asarray(fa).dtype == np.asarray(fb).dtype
        np.testing.assert_allclose(np.asarray(fa, np.float32),
                                   np.asarray(fb, np.float32),
                                   rtol=1e-4, atol=1.0 if uint8_row else 1e-2)


# test_fused_pipeline.py's PIPELINES, by id
PIPELINES = {
    "resize-norm": [("resize", dict(height=16, width=12)),
                    ("normalize", dict(mean=[1.0, 2.0, 3.0],
                                       std=[4.0, 5.0, 6.0]))],
    "crop-resize": [("crop", dict(x=2, y=3, width=14, height=16)),
                    ("resize", dict(height=10, width=10))],
    "centercrop-flip": [("centerCrop", dict(height=16, width=16)),
                        ("flip", dict(flipLeftRight=True, flipUpDown=True))],
    "boxblur-resize": [("blur", dict(height=3, width=2)),
                       ("resize", dict(height=12, width=12))],
    "gauss-flip": [("gaussianKernel", dict(apertureSize=5, sigma=1.2)),
                   ("flip", dict(flipLeftRight=True))],
    "color-resize-norm-scale": [("colorFormat", dict(format="bgr2rgb")),
                                ("resize", dict(height=8, width=8)),
                                ("normalize", dict(mean=[0.5], std=[2.0],
                                                   scale=0.5))],
    "gray-resize": [("colorFormat", dict(format="bgr2gray")),
                    ("resize", dict(height=12, width=10))],
}


@functools.lru_cache(maxsize=None)
def _jax_transformer_out(name: str, fuse: bool):
    jt, _ = _tables(_images())
    return list(_build(JS, PIPELINES[name], fuse).transform(jt)["out"])


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("name", list(PIPELINES))
def test_image_transformer_matches_jax(name, fuse):
    _, tt = _tables(_images())
    before = K.LAUNCHES
    got = _build(S, PIPELINES[name], fuse, device="cpu").transform(tt)["out"]
    assert K.LAUNCHES == before  # CPU tensors take the plain version
    _assert_rows_close(list(got), _jax_transformer_out(name, fuse))


def test_default_fuse_on_the_cpu_is_the_plain_composition(monkeypatch):
    """fuse=None plans nothing on the CPU (the kernel path is the card's);
    fuse=True takes the plan, through B1's plain version."""
    _, tt = _tables(_images())
    planned = []
    real = K.affine_plan
    monkeypatch.setattr(K, "affine_plan",
                        lambda *a: planned.append(a) or real(*a))
    _build(S, PIPELINES["boxblur-resize"], None, device="cpu").transform(tt)
    assert planned == []
    _build(S, PIPELINES["boxblur-resize"], True, device="cpu").transform(tt)
    assert len(planned) == 1


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "plain"])
def test_gray_2d_rows_match_jax(fuse):
    arrays = _images(c=1)
    assert arrays[0].ndim == 2
    stages = [("colorFormat", dict(format="gray2bgr")),
              ("resize", dict(height=10, width=10))]
    jrows = JTable({"image": arrays})  # bare 2-D arrays decode as gray rows
    ref = _build(JS, stages, fuse).transform(jrows)["out"]
    got = _build(S, stages, fuse, device="cpu").transform(
        Table({"image": arrays}))["out"]
    _assert_rows_close(list(got), list(ref))
    assert got[0]["nChannels"] == 3


def test_param_mutation_invalidates_the_cached_plan():
    _, tt = _tables(_images())
    t = _build(S, [("resize", dict(height=12, width=10))], True, device="cpu")
    first = t.transform(tt)["out"][0]["data"]
    t.set(stages=[["resize", dict(height=9, width=7)]])
    second = t.transform(tt)["out"][0]["data"]
    fresh = _build(S, [("resize", dict(height=9, width=7))], True,
                   device="cpu").transform(tt)["out"][0]["data"]
    assert first.shape == (12, 10, 3) and second.shape == (9, 7, 3)
    np.testing.assert_array_equal(second, fresh)
    t.blur(3, 3)  # a fluent add mutates the op list too
    blurred = t.transform(tt)["out"][0]["data"]
    assert not np.array_equal(blurred, second)


def test_undecodable_cells_stay_none():
    arrays = _images(n=2)
    cells = [array_to_image_row(arrays[0]), None, b"not an image",
             array_to_image_row(arrays[1])]
    out = S.ImageTransformer(output_col="out", device="cpu").flip().transform(
        Table({"image": cells}))["out"]
    assert out[1] is None and out[2] is None
    np.testing.assert_array_equal(out[0]["data"], arrays[0][:, ::-1])
    np.testing.assert_array_equal(out[3]["data"], arrays[1][:, ::-1])


@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
def test_resize_image_transformer_matches_jax(method):
    arrays = _images(n=2) + _images(n=1, h=9, w=31, seed=3)
    jt, tt = _tables(arrays)
    ref = JS.ResizeImageTransformer(height=14, width=11, method=method,
                                    output_col="out").transform(jt)["out"]
    got = S.ResizeImageTransformer(height=14, width=11, method=method,
                                   output_col="out",
                                   device="cpu").transform(tt)["out"]
    _assert_rows_close(list(got), list(ref))


def test_image_set_augmenter_matches_jax():
    jt, tt = _tables(_images(n=2))
    ref = JS.ImageSetAugmenter(flip_up_down=True).transform(jt)
    got = S.ImageSetAugmenter(flip_up_down=True, device="cpu").transform(tt)
    assert got.num_rows == ref.num_rows == 6
    for a, b in zip(got["image"], ref["image"]):
        np.testing.assert_array_equal(a["data"], b["data"])


@pytest.mark.parametrize("size", [None, (7, 9)], ids=["as-is", "resized"])
def test_unroll_binary_image_matches_jax(size):
    arrays = _images(n=2, h=12, w=10)
    data = [encode_image_row(j_row(a), "PNG") for a in arrays] + [b"junk"]
    kw = dict(height=size[0], width=size[1]) if size else {}
    ref = JS.UnrollBinaryImage(**kw).transform(JTable({"bytes": data}))
    got = S.UnrollBinaryImage(device="cpu", **kw).transform(
        Table({"bytes": data}))
    assert got["unrolled"][2] is None and ref["unrolled"][2] is None
    for a, b in zip(got["unrolled"][:2], ref["unrolled"][:2]):
        assert a.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mean,std", [(None, None),
                                      ([103.5, 116.3, 123.7], [57.4, 57.1, 58.4]),
                                      ([120.0], [64.0])],
                         ids=["defaults", "per-channel", "broadcast"])
def test_unroll_image_matches_jax(mean, std):
    arrays = _images(n=2) + _images(n=2, h=8, w=6, seed=2)
    jt, tt = _tables(arrays)
    ref = JS.UnrollImage(mean=mean, std=std).transform(jt)["unrolled"]
    before = K.LAUNCHES_UNROLL
    got = S.UnrollImage(mean=mean, std=std, device="cpu").transform(
        tt)["unrolled"]
    assert K.LAUNCHES_UNROLL == before
    for a, b in zip(got, ref):
        assert a.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape,mean,std", [
    ((3, 24, 24, 3), (0.5, 0.4, 0.3), (0.2, 0.3, 0.4)),
    ((2, 7, 5, 1), (0.25,), (3.0,)),
    ((2, 6, 9, 4), (0.1,), (0.7,)),
])
def test_fused_normalize_unroll_plain_matches_the_pallas_kernel(shape, mean, std):
    x = np.random.default_rng(11).random(shape).astype(np.float32)
    ref = np.asarray(P.fused_normalize_unroll(jnp.asarray(x), mean, std))
    got = K.fused_normalize_unroll(torch.from_numpy(x), mean, std)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        got.numpy(), K.fused_normalize_unroll_plain(torch.from_numpy(x),
                                                    mean, std).numpy())
    with pytest.raises(TypeError):
        K.fused_normalize_unroll(torch.from_numpy(x).double(), mean, std)


def test_stages_are_in_the_port_registry():
    stages = registry.all_stages()
    for name in ("ImageTransformer", "ResizeImageTransformer", "UnrollImage",
                 "UnrollBinaryImage", "ImageSetAugmenter"):
        assert stages[name] is getattr(S, name)


def test_unroll_then_torch_model_matches_tpu_model():
    hw = 32
    variables = random_flax_variables("resnet18", seed=4, hw=hw)
    jb = FlaxBundle("resnet18", {"num_classes": 10, "dtype": jnp.float32},
                    variables=variables, input_shape=(hw, hw, 3))
    tb = from_flax_variables("resnet18", variables, {"num_classes": 10},
                             input_shape=(hw, hw, 3), dtype="float32")
    arrays = _images(n=5, h=hw, w=hw, seed=9)
    jt, tt = _tables(arrays)
    mean, std = [103.53, 116.28, 123.675], [57.375, 57.12, 58.395]
    jv = JS.UnrollImage(output_col="features", mean=mean, std=std).transform(jt)
    ref = np.asarray(TPUModel(bundle=jb, input_col="features",
                              fetch_node="pool", batch_size=2)
                     .transform(jv)["output"])
    tv = S.UnrollImage(output_col="features", mean=mean, std=std,
                       device="cpu").transform(tt)
    got = TorchModel(bundle=tb, input_col="features", fetch_node="pool",
                     batch_size=2, device="cpu").transform(tv)["output"]
    assert got.shape == ref.shape == (5, 512)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
