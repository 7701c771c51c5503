"""Write the JPEG fixtures of the port's decoder tests and its digests.

    python tests/jpeg_fixtures/make_jpeg_fixtures.py

Run on a machine with PIL and the JAX package's native libjpeg decoder.
The six `bench_*.jpg` are the first six images of `bench.py`'s
`_synthetic_jpeg_table` (uniform noise from seed 0, quality 85; two each
at 256x256, 224x224 and 320x240); `gray_40x30.jpg` is a one-channel
gradient and `cmyk_40x30.jpg` a CMYK stream, which libjpeg will not turn
into BGR.  `progressive_*` (SOF2), `restart_*` (a restart interval, DRI,
every 3 MCUs or every MCU row) and `progressive_restart_*` (both, a
restart every 2 MCUs) are uniform noise from seed 1 at quality 85 at
the bench sizes: the stream kinds a JPEG decoder on the card may handle
differently from libjpeg.  `arith_224x224.jpg` is uniform noise from
seed 2 at quality 85, arithmetic-coded (SOF9), written by libjpeg
through `arith_jpeg.c`, which this script compiles with `cc -ljpeg`
(libjpeg's headers and a library built with arithmetic coding needed).  `digests.json` holds, for each fixture, what the JAX
package's `native.decode_jpeg_bgr` gives for it: the shape, the sha256
of the pixel bytes, the per-channel sums, and the pixels on a grid of
every SAMPLE-th row and column (base64), from which a decoder that is
not libjpeg can be held to a stated difference per pixel.  The CMYK
fixture's entry is null (libjpeg refuses it).
"""
import base64
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLE = 9  # coprime with the 8x8 and 16x16 blocks: every block position


def arith_jpeg(arr, quality):
    """JPEG bytes of RGB `arr` [H, W, 3] uint8, arithmetic-coded by
    libjpeg (arith_jpeg.c, compiled here)."""
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "arith_jpeg")
        subprocess.run(["cc", "-O2", os.path.join(HERE, "arith_jpeg.c"),
                        "-ljpeg", "-o", exe], check=True)
        h, w = arr.shape[:2]
        return subprocess.run([exe, str(w), str(h), str(quality)],
                              input=np.ascontiguousarray(arr).tobytes(),
                              capture_output=True, check=True).stdout


def fixtures():
    """{file name: JPEG bytes}."""
    from PIL import Image

    def jpeg(arr, mode=None, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr, mode=mode).save(buf, format="JPEG", **kw)
        return buf.getvalue()

    out = {}
    rng = np.random.default_rng(0)
    sizes = [(256, 256), (224, 224), (320, 240)]
    for i in range(6):  # bench.py _synthetic_jpeg_table, first six
        h, w = sizes[i % len(sizes)]
        arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        out[f"bench_{i}_{h}x{w}.jpg"] = jpeg(arr, quality=85)
    gray = np.linspace(0, 255, 40 * 30).reshape(40, 30).astype(np.uint8)
    out["gray_40x30.jpg"] = jpeg(gray, quality=85)
    rng = np.random.default_rng(1)
    for name, (h, w), kw in (
            ("progressive_224x224.jpg", (224, 224), {"progressive": True}),
            ("restart_224x224.jpg", (224, 224), {"restart_marker_blocks": 3}),
            ("restart_rows_320x240.jpg", (320, 240),
             {"restart_marker_rows": 1}),
            ("progressive_restart_256x256.jpg", (256, 256),
             {"progressive": True, "restart_marker_blocks": 2})):
        arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        out[name] = jpeg(arr, quality=85, **kw)
    cmyk = Image.new("CMYK", (30, 40))
    cmyk.putdata([(i % 256, 50, 100, 0) for i in range(30 * 40)])
    buf = io.BytesIO()
    cmyk.save(buf, format="JPEG")
    out["cmyk_40x30.jpg"] = buf.getvalue()
    out["arith_224x224.jpg"] = arith_jpeg(np.random.default_rng(2).integers(
        0, 256, size=(224, 224, 3), dtype=np.uint8), 85)
    return out


def digest(arr):
    """The digest entry of decoded pixels (None for a refused stream)."""
    if arr is None:
        return None
    return {"shape": list(arr.shape),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "channel_sums": [int(s) for s in
                             arr.reshape(-1, arr.shape[2]).sum(0, np.int64)],
            "sample": base64.b64encode(np.ascontiguousarray(
                arr[::SAMPLE, ::SAMPLE]).tobytes()).decode()}


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from mmlspark_tpu import native

    if not native.jpeg_available():
        sys.exit("the JAX package's native decoder was built without libjpeg")
    digests = {"sample_stride": SAMPLE, "decoder": "mmlspark_tpu.native "
               "decode_jpeg_bgr (libjpeg)", "fixtures": {}}
    for name, blob in fixtures().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(blob)
        digests["fixtures"][name] = digest(native.decode_jpeg_bgr(blob))
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
