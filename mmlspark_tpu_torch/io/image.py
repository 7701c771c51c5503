"""Image IO: image rows <-> arrays, and the host decode of an image column.

A copy of the JAX package's `io/image.py` (row helpers,
`encode_image_row`, `read_binary_files`, `read_image_dir`) and of
`ops/image_stages.py::decode_cells`, for this package.  Reference: core
io/image/ImageUtils.scala:26-165 (decode bytes -> image row; `safeRead`
tolerant decode) and PatchedImageFileFormat.scala:154 (the image
source).

An "image row" is a dict with the Spark image schema fields
(origin, height, width, nChannels, mode, data) where `data` is an
HWC uint8 ndarray in **BGR** channel order (OpenCV/Spark convention).

Encoded JPEGs decode through the port's own native decoder
(`mmlspark_tpu_torch.native`) first; anything else, and any native
failure, goes through PIL, imported lazily — as the JAX package's
`decode_image` does.
"""
from __future__ import annotations

import io as _io
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from ..core.schema import Table

__all__ = ["array_to_image_row", "image_row_to_array", "decode_image",
           "safe_read", "decode_cells", "encode_image_row",
           "read_binary_files", "read_image_dir"]

OCV_8UC1 = 0
OCV_8UC3 = 16
OCV_8UC4 = 24


def array_to_image_row(arr: np.ndarray, origin: str = "") -> Dict[str, Any]:
    arr = np.asarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    mode = {1: OCV_8UC1, 3: OCV_8UC3, 4: OCV_8UC4}[c]
    return {"origin": origin, "height": h, "width": w, "nChannels": c,
            "mode": mode, "data": arr}


def image_row_to_array(row: Dict[str, Any]) -> np.ndarray:
    data = row["data"]
    if isinstance(data, (bytes, bytearray)):
        data = np.frombuffer(data, dtype=np.uint8)
    arr = np.asarray(data, dtype=np.uint8)
    return arr.reshape(row["height"], row["width"], row["nChannels"])


def decode_image(data: bytes, origin: str = "") -> Dict[str, Any]:
    """Decode compressed bytes (png/jpeg/bmp/...) to a BGR image row.

    JPEGs take the native decoder (BGR from the decoder, GIL released);
    everything else, and a JPEG the decoder refuses (CMYK, truncation),
    goes through PIL.  A failure of the decoder itself
    (`native.DecoderError`) raises."""
    if data[:3] == b"\xff\xd8\xff":
        from .. import native

        arr = native.decode_jpeg_bgr(data)
        if arr is not None:
            return array_to_image_row(arr, origin)
    from PIL import Image

    img = Image.open(_io.BytesIO(data))
    if img.mode not in ("RGB", "L", "RGBA"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[2] >= 3:
        arr = arr[:, :, :3][:, :, ::-1]  # RGB(A) -> BGR
    return array_to_image_row(arr, origin)


def safe_read(data: Optional[bytes], origin: str = "") -> Optional[Dict[str, Any]]:
    """Tolerant decode: None on failure (ImageUtils.safeRead).  A decoder
    that failed to build or failed on the card (`native.DecoderError`) is
    not a bad image and raises."""
    from ..native import DecoderError

    if data is None:
        return None
    try:
        return decode_image(data, origin)
    except DecoderError:
        raise
    except Exception:  # noqa: BLE001 — by contract: any decode failure -> None
        return None


def _decode_cell(v: Any) -> Optional[Dict[str, Any]]:
    """Accept image rows, raw encoded bytes, or ndarray."""
    if v is None:
        return None
    if isinstance(v, dict):
        return v
    if isinstance(v, (bytes, bytearray)):
        return safe_read(bytes(v))
    if isinstance(v, np.ndarray) and v.ndim >= 2:
        return array_to_image_row(v)
    return None


def decode_cells(col: np.ndarray) -> list:
    """Decode a whole image column (rows/bytes/arrays -> image rows, None
    for undecodable cells).  Cells that are already decoded (image-row
    dicts, ndarray pixels) are wrapped inline; only encoded bytes pay a
    codec, thread-pooled for larger columns (PIL releases the GIL).  Wall
    time and item count land in the pipeline telemetry's "decode"
    stage."""
    from ..core import telemetry as core_telemetry
    from .pipeline import PIPELINE_TELEMETRY

    out: list = [None] * len(col)
    pending: list = []  # indices still needing a codec (bytes/unknown)
    for i, v in enumerate(col):
        if v is None:
            continue
        if isinstance(v, dict):
            out[i] = v
        elif isinstance(v, np.ndarray) and v.ndim >= 2:
            out[i] = array_to_image_row(v)
        else:
            pending.append(i)
    if not pending:
        return out
    t0 = time.perf_counter()
    if len(pending) > 32:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
                max_workers=min(16, os.cpu_count() or 4)) as ex:
            rows = list(ex.map(_decode_cell, (col[i] for i in pending)))
    else:
        rows = [_decode_cell(col[i]) for i in pending]
    for i, row in zip(pending, rows):
        out[i] = row
    dt = time.perf_counter() - t0
    PIPELINE_TELEMETRY.add("decode", busy_s=dt, items=len(pending))
    core_telemetry.histogram("io.pipeline.stage.latency",
                             stage="decode").observe(dt)
    return out


def encode_image_row(row: Dict[str, Any], fmt: str = "PNG") -> bytes:
    """Image row -> encoded bytes (PIL), BGR turned back to RGB."""
    from PIL import Image

    arr = image_row_to_array(row)
    if arr.shape[2] == 3:
        arr = arr[:, :, ::-1]  # BGR -> RGB
    elif arr.shape[2] == 1:
        arr = arr[:, :, 0]
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def read_binary_files(pattern: str, recursive: bool = True,
                      sample_ratio: float = 1.0) -> Table:
    """(path, bytes) table from a glob — BinaryFileFormat analog; delegates
    to the canonical threaded reader in io/binary.py."""
    from .binary import read_binary_files as _impl

    return _impl(pattern, recursive=recursive, sample_ratio=sample_ratio)


def read_image_dir(pattern: str, drop_invalid: bool = True) -> Table:
    """Image-source analog (PatchedImageFileFormat.scala:154): decode every
    file under the glob into an `image` column of image rows."""
    files = read_binary_files(pattern)
    rows = [safe_read(b, origin=p) for p, b in zip(files["path"], files["bytes"])]
    t = Table({"image": rows})
    if drop_invalid:
        mask = np.array([r is not None for r in rows])
        t = t.filter(mask)
    return t
