"""The port's JPEG path held against the JAX package on this box.

The native decoder (`mmlspark_tpu_torch.native`, built here on libjpeg)
gives the JAX package's `native.decode_jpeg_bgr` pixels byte for byte and
its `jpeg_probe` shapes, in the cases of tests/test_native.py: colour,
grayscale, DCT-domain scale_denom, garbage, a truncated stream, the
decompression-bomb guard and `decode_jpeg_bgr_into`; and it decodes the
committed fixtures of tests/jpeg_fixtures/ to their digests.  Then the
featurizer's JPEG-bytes fast path against the JAX ImageFeaturizer on the
same bridged ResNet-18 weights, in the cases of
tests/test_featurizer_streaming.py, at the f32 tolerance of
test_torch_featurizer.py (rtol 1e-4, atol 1e-4 of the largest feature).
Last, C2's witnesses: the plain version of the nvJPEG decoder's
upsampling and colour conversion (ops/jpeg_color.py) on libjpeg's raw
planes equals libjpeg's BGR byte for byte (4:4:4, 4:2:2, 4:2:0 and RGB
streams of odd sizes, and the fixtures); a decoder that fails to build
raises.
"""
import base64
import hashlib
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from mmlspark_tpu import Table as JTable
from mmlspark_tpu import native as jnative
from mmlspark_tpu.io.image import decode_image as jdecode_image
from mmlspark_tpu.models.bundle import FlaxBundle
from mmlspark_tpu.models.image_featurizer import ImageFeaturizer as JFeaturizer
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch import native
from mmlspark_tpu_torch.io.feed import FEED_TELEMETRY
from mmlspark_tpu_torch.io.image import (decode_image, image_row_to_array,
                                         safe_read)
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.ops.jpeg_color import ycc_to_bgr

from torch_port_util import random_flax_variables

torch.set_num_threads(2)

HW = 32
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "jpeg_fixtures")


def _jpeg(arr, quality=85, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _cmyk(rng):
    img = Image.new("CMYK", (30, 40))
    img.putdata([(int(i) % 256, 50, 100, 0)
                 for i in rng.integers(0, 255, 30 * 40)])
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    return buf.getvalue()


def _noise(rng, shape):
    return rng.integers(0, 255, shape).astype(np.uint8)


# ---- the decoder ---------------------------------------------------------

def test_decoder_builds_on_libjpeg_here():
    assert jnative.jpeg_available()  # the reference decodes JPEG here
    assert native.jpeg_available(), native.build_error()
    assert native.jpeg_backend() == "libjpeg"
    assert native.build_error() is None


@pytest.mark.parametrize("kind", ["gradient", "noise", "gray", "odd"])
def test_decode_and_probe_equal_the_reference(kind):
    rng = np.random.default_rng(0)
    if kind == "gradient":  # tests/test_native.py's smooth image
        base = np.linspace(0, 255, 32 * 24 * 3).reshape(32, 24, 3)
        blob = _jpeg((base + rng.normal(0, 8, base.shape)).clip(0, 255)
                     .astype(np.uint8), quality=92)
    elif kind == "noise":
        blob = _jpeg(_noise(rng, (40, 30, 3)))
    elif kind == "gray":
        blob = _jpeg(np.linspace(0, 255, 256).reshape(16, 16)
                     .astype(np.uint8), mode="L")
    else:
        blob = _jpeg(_noise(rng, (17, 23, 3)), quality=60)
    got, ref = native.decode_jpeg_bgr(blob), jnative.decode_jpeg_bgr(blob)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert native.jpeg_probe(blob) == jnative.jpeg_probe(blob) == got.shape


@pytest.mark.parametrize("denom", [2, 4, 8])
def test_scale_denom_equals_the_reference(denom):
    blob = _jpeg(_noise(np.random.default_rng(1), (64, 48, 3)), quality=92)
    got = native.decode_jpeg_bgr(blob, scale_denom=denom)
    assert got.shape == (64 // denom, 48 // denom, 3)
    np.testing.assert_array_equal(
        got, jnative.decode_jpeg_bgr(blob, scale_denom=denom))
    assert native.jpeg_probe(blob, denom) == jnative.jpeg_probe(blob, denom)


def test_garbage_and_truncated_streams_give_none():
    blob = _jpeg(_noise(np.random.default_rng(3), (64, 64, 3)), quality=90)
    truncated = blob[:len(blob) // 2]
    for data in (b"\xff\xd8\xffgarbage", b"", truncated):
        assert native.decode_jpeg_bgr(data) is None
        assert jnative.decode_jpeg_bgr(data) is None
    assert native.jpeg_probe(b"xx") is None
    # the header of the truncated stream is whole: the probe reads it
    assert native.jpeg_probe(truncated) == jnative.jpeg_probe(truncated)
    assert safe_read(truncated) is None


def test_decompression_bomb_guard(monkeypatch):
    blob = _jpeg(np.zeros((32, 32, 3), np.uint8))
    assert native.decode_jpeg_bgr(blob) is not None
    monkeypatch.setattr(native, "MAX_JPEG_PIXELS", 100)
    assert native.decode_jpeg_bgr(blob) is None
    assert native.jpeg_probe(blob) is None


def test_decode_into_a_chunk_slot():
    blob = _jpeg(_noise(np.random.default_rng(4), (24, 18, 3)))
    ref = jnative.decode_jpeg_bgr(blob)
    chunk = np.zeros((3,) + ref.shape, np.uint8)
    assert native.decode_jpeg_bgr_into(blob, chunk[1])
    np.testing.assert_array_equal(chunk[1], ref)
    assert not chunk[0].any() and not chunk[2].any()
    assert not native.decode_jpeg_bgr_into(blob, np.zeros((10, 10, 3), np.uint8))
    assert not native.decode_jpeg_bgr_into(b"junk", np.zeros_like(ref))
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native.decode_jpeg_bgr_into(blob, np.zeros((18, 24, 3), np.uint8).T)


def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_digests()["fixtures"]))
def test_fixture_decodes_to_its_digest(name):
    """The committed fixtures (bench.py's JPEG recipe) decode to the
    digests the JAX package's decoder gave when they were made."""
    d = _digests()
    want = d["fixtures"][name]
    with open(os.path.join(FIXTURES, name), "rb") as f:
        blob = f.read()
    got = native.decode_jpeg_bgr(blob)
    if want is None:  # CMYK: libjpeg refuses it, the featurizer uses PIL
        assert got is None
        assert native.jpeg_probe(blob) == (40, 30, 3)
        return
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    sums = got.reshape(-1, got.shape[2]).sum(0, np.int64)
    assert sums.tolist() == want["channel_sums"]
    k = d["sample_stride"]
    sample = np.ascontiguousarray(got[::k, ::k])
    assert base64.b64encode(sample.tobytes()).decode() == want["sample"]


def test_decode_image_routes_jpeg_through_the_native_decoder(monkeypatch):
    rng = np.random.default_rng(2)
    blob = _jpeg(_noise(rng, (20, 20, 3)))
    np.testing.assert_array_equal(
        image_row_to_array(decode_image(blob)),
        native.decode_jpeg_bgr(blob))
    np.testing.assert_array_equal(
        image_row_to_array(decode_image(blob)),
        np.asarray(jdecode_image(blob)["data"]))
    png = _png(_noise(rng, (12, 9, 3)))
    np.testing.assert_array_equal(image_row_to_array(decode_image(png)),
                                  np.asarray(jdecode_image(png)["data"]))
    # CMYK: the native decoder refuses it, PIL decodes it, as the JAX
    # package's decode_image does
    cmyk = _cmyk(rng)
    np.testing.assert_array_equal(image_row_to_array(decode_image(cmyk)),
                                  np.asarray(jdecode_image(cmyk)["data"]))
    calls = []
    monkeypatch.setattr(native, "decode_jpeg_bgr",
                        lambda data: calls.append(data))  # returns None
    decode_image(blob)  # a native failure falls through to PIL
    assert calls == [blob]


# ---- the featurizer's fast path -----------------------------------------

@pytest.fixture(scope="module")
def bundles():
    variables = random_flax_variables("resnet18", seed=3, hw=HW)
    jb = FlaxBundle("resnet18", {"num_classes": 10, "dtype": jnp.float32},
                    variables=variables, input_shape=(HW, HW, 3))
    tb = from_flax_variables("resnet18", variables, {"num_classes": 10},
                             input_shape=(HW, HW, 3), dtype="float32")
    return jb, tb


def _both(bundles, cells, **kw):
    """(port output, JAX output) of ImageFeaturizer over the same column
    with ids, the port on the CPU."""
    jb, tb = bundles
    ids = np.arange(len(cells))
    ref = JFeaturizer(bundle=jb, **kw).transform(
        JTable({"image": cells, "id": ids}))
    got = ImageFeaturizer(bundle=tb, device="cpu", **kw).transform(
        Table({"image": cells, "id": ids}))
    return got, ref


def _assert_same(got, ref):
    np.testing.assert_array_equal(got["id"], np.asarray(ref["id"]))
    f_got, f_ref = got["features"], np.asarray(ref["features"])
    assert f_got.shape == f_ref.shape and f_got.dtype == np.float32
    scale = float(np.abs(f_ref).max()) if f_ref.size else 1.0
    np.testing.assert_allclose(f_got, f_ref, rtol=1e-4, atol=1e-4 * scale)


@pytest.fixture
def spy(monkeypatch):
    """{"streaming": calls} of the port's fast path."""
    seen = {"streaming": 0}
    orig = ImageFeaturizer._transform_bytes_streaming

    def wrapped(self, table, b):
        seen["streaming"] += 1
        return orig(self, table, b)

    monkeypatch.setattr(ImageFeaturizer, "_transform_bytes_streaming", wrapped)
    return seen


def test_bytes_column_takes_the_streaming_path(bundles, spy):
    rng = np.random.default_rng(10)
    blobs = [_jpeg(_noise(rng, (40, 30, 3))) for _ in range(5)]
    before = FEED_TELEMETRY.snapshot()
    got, ref = _both(bundles, blobs, batch_size=2)
    assert spy["streaming"] == 1
    assert got["features"].shape == (5, 512)
    _assert_same(got, ref)
    # the decode runs on the HostPipeline workers: the feed waits on it
    # as stall_decode_s, as in the JAX package
    d = FEED_TELEMETRY.delta(before)
    assert d["chunks_fed"] == 3 and d["stall_decode_s"] > 0


def test_streaming_equals_the_general_path(bundles):
    _, tb = bundles
    rng = np.random.default_rng(11)
    blobs = [_jpeg(_noise(rng, (40, 30, 3))) for _ in range(6)]
    f = ImageFeaturizer(bundle=tb, batch_size=4, device="cpu")
    streamed = f.transform(Table({"image": blobs}))["features"]
    rows = [decode_image(b) for b in blobs]
    general = f.transform(Table({"image": rows}))["features"]
    np.testing.assert_allclose(streamed, general, rtol=1e-5, atol=1e-5)


def test_mixed_jpeg_png_and_shapes(bundles, spy):
    rng = np.random.default_rng(12)
    cells = [_jpeg(_noise(rng, (40, 30, 3))), _png(_noise(rng, (32, 32, 3))),
             _jpeg(_noise(rng, (32, 32, 3))),
             _jpeg(rng.integers(0, 255, (40, 30), dtype=np.uint8))]  # gray
    got, ref = _both(bundles, cells, batch_size=2)
    assert spy["streaming"] == 1
    assert got["features"].shape == (4, 512)
    _assert_same(got, ref)


def test_order_is_kept_across_shape_groups(bundles):
    rng = np.random.default_rng(13)
    blobs = [_jpeg(_noise(rng, (40, 30, 3) if i % 2 else (32, 32, 3)))
             for i in range(8)]
    got, ref = _both(bundles, blobs, batch_size=3)
    _assert_same(got, ref)


def test_cmyk_jpeg_falls_back_to_pil(bundles, spy):
    rng = np.random.default_rng(14)
    cells = [_jpeg(_noise(rng, (40, 30, 3))), _cmyk(rng)]
    got, ref = _both(bundles, cells, batch_size=2)
    assert spy["streaming"] == 1 and got.num_rows == 2
    _assert_same(got, ref)


def test_mostly_png_column_keeps_the_general_path(bundles, spy):
    rng = np.random.default_rng(15)
    cells = [_png(_noise(rng, (32, 32, 3))) for _ in range(4)]
    cells.append(_jpeg(_noise(rng, (32, 32, 3))))
    got, ref = _both(bundles, cells, batch_size=2)
    assert spy["streaming"] == 0
    _assert_same(got, ref)


def test_without_a_decoder_jpeg_columns_take_the_general_path(
        bundles, spy, monkeypatch):
    rng = np.random.default_rng(16)
    blobs = [_jpeg(_noise(rng, (32, 32, 3))) for _ in range(3)]
    _, tb = bundles
    pil_rows = [{"height": 32, "width": 32, "nChannels": 3,
                 "data": np.asarray(Image.open(io.BytesIO(b)))[:, :, ::-1]}
                for b in blobs]
    want = ImageFeaturizer(bundle=tb, device="cpu").transform(
        Table({"image": pil_rows}))["features"]
    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    monkeypatch.setattr(native, "decode_jpeg_bgr", lambda data: None)
    got = ImageFeaturizer(bundle=tb, device="cpu").transform(
        Table({"image": blobs}))["features"]  # PIL decodes every row
    assert spy["streaming"] == 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_undecodable_rows_are_dropped(bundles):
    rng = np.random.default_rng(17)
    good = _jpeg(_noise(rng, (32, 32, 3)))
    truncated = good[:len(good) // 2]  # probe succeeds, decode fails
    got, ref = _both(bundles, [good, b"not-an-image", truncated, None, good],
                     batch_size=2)
    assert list(got["id"]) == [0, 4]
    _assert_same(got, ref)


def test_drop_na_false_raises_before_any_compute(bundles, monkeypatch):
    _, tb = bundles
    good = _jpeg(_noise(np.random.default_rng(18), (32, 32, 3)))
    monkeypatch.setattr(native, "decode_jpeg_bgr_into",
                        lambda *a: pytest.fail("decoded before raising"))
    for f in (JFeaturizer(bundle=bundles[0], drop_na=False),
              ImageFeaturizer(bundle=tb, drop_na=False, device="cpu")):
        table_cls = JTable if isinstance(f, JFeaturizer) else Table
        with pytest.raises(ValueError, match="undecodable"):
            f.transform(table_cls({"image": [good, b"junk"]}))


def test_multi_chunk_group(bundles):
    rng = np.random.default_rng(19)
    blobs = [_jpeg(_noise(rng, (32, 32, 3))) for _ in range(7)]
    got, ref = _both(bundles, blobs, batch_size=3)
    assert got["features"].shape == (7, 512)
    _assert_same(got, ref)


def test_fixture_column_matches_the_reference(bundles):
    """bench.py's JPEG recipe at its three sizes (the committed fixtures)."""
    names = sorted(n for n in os.listdir(FIXTURES) if n.startswith("bench_"))
    blobs = []
    for n in names:
        with open(os.path.join(FIXTURES, n), "rb") as f:
            blobs.append(f.read())
    got, ref = _both(bundles, blobs, batch_size=2)
    assert got["features"].shape == (6, 512)
    _assert_same(got, ref)


# ---- C2: libjpeg's upsampling and colour conversion ----------------------
# ops/jpeg_color.py's plain version (the oracle of the C2 kernel on the
# card) on libjpeg's raw component planes (`raw_data_out`) must give
# libjpeg's own BGR byte for byte: odd sizes exercise the last row pair
# and column of 4:2:0 / 4:2:2 chroma and the edge replication, widths of
# 1-2 chroma samples libjpeg's box-replication branch.

C2_SIZES = [(17, 23), (33, 17), (3, 5), (9, 2), (1, 1)]


def _c2_case(blob):
    layout, planes = native.decode_jpeg_planes(blob)
    got = ycc_to_bgr([torch.from_numpy(p) for p in planes], layout.factors,
                     layout.height, layout.width, layout.color)
    return layout, planes, got.numpy()


@pytest.mark.parametrize("size", C2_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_c2_plain_upsample_and_convert_equals_libjpeg(subsampling, size):
    rng = np.random.default_rng(sum(size))
    buf = io.BytesIO()
    Image.fromarray(_noise(rng, size + (3,))).save(
        buf, format="JPEG", quality=85, subsampling=subsampling)
    blob = buf.getvalue()
    layout, planes, got = _c2_case(blob)
    h, w = size
    hs, vs = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}[subsampling]
    assert layout.factors == ((hs, vs), (1, 1), (1, 1)) and layout.color == 1
    assert [p.shape for p in planes] == [
        (h, w), (-(-h // vs), -(-w // hs)), (-(-h // vs), -(-w // hs))]
    np.testing.assert_array_equal(got, native.decode_jpeg_bgr(blob))
    np.testing.assert_array_equal(got, jnative.decode_jpeg_bgr(blob))


@pytest.mark.parametrize("name", sorted(n for n in _digests()["fixtures"]
                                        if n.startswith("bench_")))
def test_c2_plain_on_the_fixtures_gives_their_digest(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        blob = f.read()
    _layout, _planes, got = _c2_case(blob)
    want = _digests()["fixtures"][name]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]


def test_c2_rgb_stream_is_upsampled_without_conversion():
    """An RGB JPEG (R, G, B component ids, no JFIF marker): libjpeg only
    swaps its components into BGR."""
    buf = io.BytesIO()
    Image.fromarray(_noise(np.random.default_rng(5), (13, 11, 3))).save(
        buf, format="JPEG", quality=90, keep_rgb=True)
    blob = buf.getvalue()
    layout, _planes, got = _c2_case(blob)
    assert layout.color == 2
    np.testing.assert_array_equal(got, native.decode_jpeg_bgr(blob))


def test_c2_layout_and_planes_of_gray_and_cmyk():
    gray = _jpeg(np.linspace(0, 255, 12 * 7).reshape(12, 7).astype(np.uint8),
                 mode="L")
    layout, planes = native.decode_jpeg_planes(gray)
    assert layout.color == 0 and layout.factors == ((1, 1),)
    np.testing.assert_array_equal(planes[0],
                                  native.decode_jpeg_bgr(gray)[:, :, 0])
    cmyk = _cmyk(np.random.default_rng(6))
    assert native.jpeg_layout(cmyk).color == -1
    assert native.decode_jpeg_planes(cmyk) is None
    assert native.decode_jpeg_planes(b"\xff\xd8\xffjunk") is None
    assert native.ycc_launches() == 0  # the kernel is the nvJPEG backend's


def test_c2_wrapper_checks_its_planes():
    blob = _jpeg(_noise(np.random.default_rng(7), (9, 7, 3)))
    layout, planes = native.decode_jpeg_planes(blob)
    t = [torch.from_numpy(p) for p in planes]
    args = (layout.factors, layout.height, layout.width)
    with pytest.raises(ValueError, match="expected"):
        ycc_to_bgr([t[0], t[0], t[2]], *args)
    with pytest.raises(ValueError, match="uint8"):
        ycc_to_bgr([t[0], t[1].int(), t[2]], *args)
    with pytest.raises(ValueError, match="color"):
        ycc_to_bgr(t, *args, color=0)
    with pytest.raises(ValueError, match="integer ratios"):
        ycc_to_bgr(t, ((3, 1), (2, 1), (1, 1)), 9, 7)


def test_a_decoder_that_fails_to_build_raises(monkeypatch, tmp_path):
    """No other route decodes in place of a backend the machine has: a
    failed build raises DecoderError from every entry, and safe_read
    does not turn it into a dropped row."""
    monkeypatch.setattr(native, "_STATE", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_choose", lambda cxx: (
        "nvjpeg", (str(tmp_path / "no-nvcc"), "-O3")))
    blob = _jpeg(_noise(np.random.default_rng(8), (8, 8, 3)))
    for call in (native.jpeg_available, lambda: native.decode_jpeg_bgr(blob),
                 lambda: safe_read(blob), native.ycc_launches):
        with pytest.raises(native.DecoderError, match="did not build"):
            call()
    assert "did not build" in native.build_error()


class _Failing:
    """The built decoder library with some C entries returning a code."""

    def __init__(self, lib, **codes):
        self._lib, self._codes = lib, codes

    def __getattr__(self, name):
        if name in self._codes:
            return lambda *args: self._codes[name]
        return getattr(self._lib, name)


@pytest.fixture
def no_pil(monkeypatch):
    """PIL.Image.open fails the test: no row is decoded by PIL instead.
    (pytest.fail's exception is not an Exception, so safe_read's
    catch-all does not swallow it.)"""
    monkeypatch.setattr(Image, "open",
                        lambda *a, **k: pytest.fail("decoded by PIL"))


@pytest.mark.parametrize("code", [-5, -6])
def test_a_decode_that_fails_on_the_card_raises_from_every_caller(
        bundles, monkeypatch, no_pil, code):
    """-5 (the card or nvJPEG failed) and -6 (nvJPEG's sizes disagree
    with the header) are the decoder's failures, not a refused stream:
    decode_image, safe_read, decode_jpeg_bgr(_into) and the featurizer's
    JPEG path raise DecoderError, and nothing decodes the row instead."""
    native._load()
    monkeypatch.setitem(native._STATE, "lib", _Failing(
        native._STATE["lib"], mml_jpeg_decode_bgr=code,
        mml_jpeg_decode_planes=code))
    blob = _jpeg(_noise(np.random.default_rng(20), (12, 10, 3)))
    assert native.jpeg_probe(blob) == (12, 10, 3)
    for call in (lambda: decode_image(blob), lambda: safe_read(blob),
                 lambda: native.decode_jpeg_bgr(blob),
                 lambda: native.decode_jpeg_bgr_into(
                     blob, np.empty((12, 10, 3), np.uint8)),
                 lambda: native.decode_jpeg_planes(blob)):
        with pytest.raises(native.DecoderError, match=f"code {code}"):
            call()
    featurizer = ImageFeaturizer(bundle=bundles[1], device="cpu",
                                 batch_size=2)
    with pytest.raises(native.DecoderError, match=f"code {code}"):
        featurizer.transform(Table({"image": [blob, blob, blob]}))


@pytest.mark.parametrize("code", [-5, -6])
def test_a_probe_that_fails_on_the_card_raises(bundles, monkeypatch, no_pil,
                                               code):
    """The featurizer probes every JPEG before any decode: a failed probe
    raises instead of sending the row to the PIL path."""
    native._load()
    monkeypatch.setitem(native._STATE, "lib", _Failing(
        native._STATE["lib"], mml_jpeg_probe=code))
    blob = _jpeg(_noise(np.random.default_rng(21), (12, 10, 3)))
    for call in (lambda: native.jpeg_probe(blob),
                 lambda: native.decode_jpeg_bgr(blob), lambda: safe_read(blob)):
        with pytest.raises(native.DecoderError, match="probe"):
            call()
    featurizer = ImageFeaturizer(bundle=bundles[1], device="cpu")
    with pytest.raises(native.DecoderError, match="probe"):
        featurizer.transform(Table({"image": [blob, blob]}))


def test_a_refused_stream_still_goes_to_pil(bundles, monkeypatch):
    """-1, a stream the decoder refuses, keeps its meaning: None from the
    decoder, and the row decoded by PIL as in the JAX package."""
    native._load()
    monkeypatch.setitem(native._STATE, "lib", _Failing(
        native._STATE["lib"], mml_jpeg_decode_bgr=-1))
    blob = _jpeg(_noise(np.random.default_rng(22), (12, 10, 3)))
    assert native.decode_jpeg_bgr(blob) is None
    row = decode_image(blob)
    np.testing.assert_array_equal(
        image_row_to_array(row),
        np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))[:, :, ::-1])
