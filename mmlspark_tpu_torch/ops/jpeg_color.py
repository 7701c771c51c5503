"""C2: a JPEG's component planes -> interleaved BGR, as libjpeg does it.

The decoder's last pass: upsample each component plane from its own,
downsampled size to the image's, then convert YCbCr to BGR, with the
integer arithmetic of the Independent JPEG Group's libjpeg as
libjpeg-turbo keeps it (`jdsample.c`: `h2v1_fancy_upsample`,
`h1v2_fancy_upsample`, `h2v2_fancy_upsample`, `int_upsample`;
`jdcolor.c`: `build_ycc_rgb_table`, `ycc_rgb_convert`).  On the card the
pass is the kernel of `native/src/jpeg_ycc.cu`, which the nvJPEG decoder
launches on the planes it decodes (`native.decode_jpeg_bgr`); its launch
count is `native.ycc_launches()`.

`ycc_to_bgr` takes the planes as tensors: on the card it launches that
kernel, on the CPU it runs the plain version below, which is the tests'
oracle (held against libjpeg's own BGR on libjpeg's raw planes) and
which no decode path runs.  The plane of a component with sampling
factors (h, v) in an H x W image has ceil(H * v / vmax) rows and
ceil(W * h / hmax) columns (`native.JpegLayout.plane_shapes`); a
neighbour beyond a plane's edge is the edge sample itself, as libjpeg's
context rows and end columns make it.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..native import JpegLayout

__all__ = ["ycc_to_bgr", "ycc_to_bgr_plain", "upsample_plain"]

# jdcolor.c's fixed point: SCALEBITS 16, FIX(x) = round(x * 2^16)
_ONE_HALF = 1 << 15
_FIX_1_40200 = 91881
_FIX_1_77200 = 116130
_FIX_0_71414 = 46802
_FIX_0_34414 = 22554


def _shift(s: torch.Tensor, dim: int, by: int) -> torch.Tensor:
    """`s` moved one sample along `dim` (by -1: each sample's left / upper
    neighbour; +1: right / lower), the edge sample repeated."""
    n = s.shape[dim]
    if by < 0:
        idx = torch.cat([torch.zeros(1, dtype=torch.long),
                         torch.arange(n - 1)])
    else:
        idx = torch.cat([torch.arange(1, n), torch.tensor([n - 1])])
    return s.index_select(dim, idx.to(s.device))


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along `dim`."""
    out = torch.stack([a, b], dim + 1)
    shape = list(a.shape)
    shape[dim] *= 2
    return out.reshape(shape)


def upsample_plain(plane: torch.Tensor, hexp: int, vexp: int, height: int,
                   width: int) -> torch.Tensor:
    """One component plane [rows, cols] uint8 expanded `hexp` across and
    `vexp` down, cut to [height, width] (int32), by libjpeg's method for
    the ratio."""
    s = plane.to(torch.int32)
    w = s.shape[1]
    if hexp == 1 and vexp == 1:
        out = s
    elif hexp == 2 and vexp == 1 and w > 2:  # h2v1_fancy_upsample
        out = _interleave((3 * s + _shift(s, 1, -1) + 1) >> 2,
                          (3 * s + _shift(s, 1, 1) + 2) >> 2, 1)
    elif hexp == 1 and vexp == 2:  # h1v2_fancy_upsample
        out = _interleave((3 * s + _shift(s, 0, -1) + 1) >> 2,
                          (3 * s + _shift(s, 0, 1) + 2) >> 2, 0)
    elif hexp == 2 and vexp == 2 and w > 2:  # h2v2_fancy_upsample
        rows = []
        for far in (_shift(s, 0, -1), _shift(s, 0, 1)):
            col = 3 * s + far  # the column sums of the output row
            rows.append(_interleave((3 * col + _shift(col, 1, -1) + 8) >> 4,
                                    (3 * col + _shift(col, 1, 1) + 7) >> 4,
                                    1))
        out = _interleave(rows[0], rows[1], 0)
    else:  # int_upsample: box replication
        out = s.repeat_interleave(vexp, 0).repeat_interleave(hexp, 1)
    return out[:height, :width]


def _expansions(factors: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    if any(hmax % h or vmax % v for h, v in factors):
        raise ValueError(f"sampling factors {list(factors)}: libjpeg "
                         "upsamples integer ratios only")
    return [(hmax // h, vmax // v) for h, v in factors]


def _check(planes: Sequence[torch.Tensor], factors, height: int, width: int,
           color: int) -> None:
    if len(planes) != 3 or len(factors) != 3:
        raise ValueError("ycc_to_bgr takes three planes and their factors")
    if color not in (1, 2):
        raise ValueError(f"color {color}: 1 (YCbCr) or 2 (RGB)")
    _expansions(factors)
    want = JpegLayout(height, width, color, tuple(map(tuple, factors)))
    for p, shape in zip(planes, want.plane_shapes()):
        if p.dtype != torch.uint8 or tuple(p.shape) != shape:
            raise ValueError(f"a plane of {tuple(p.shape)} {p.dtype}, "
                             f"expected {shape} uint8")
        if p.device != planes[0].device:
            raise ValueError("the planes lie on different devices")


def ycc_to_bgr_plain(planes: Sequence[torch.Tensor],
                     factors: Sequence[Tuple[int, int]], height: int,
                     width: int, color: int = 1) -> torch.Tensor:
    """The plain version: [height, width, 3] uint8 BGR from the three
    component planes (YCbCr, or R, G, B where `color` is 2)."""
    _check(planes, factors, height, width, color)
    c0, c1, c2 = (upsample_plain(p, hx, vx, height, width)
                  for p, (hx, vx) in zip(planes, _expansions(factors)))
    if color == 2:
        return torch.stack([c2, c1, c0], -1).to(torch.uint8)
    cb, cr = c1 - 128, c2 - 128
    r = c0 + ((_FIX_1_40200 * cr + _ONE_HALF) >> 16)
    b = c0 + ((_FIX_1_77200 * cb + _ONE_HALF) >> 16)
    g = c0 + ((-_FIX_0_71414 * cr - _FIX_0_34414 * cb + _ONE_HALF) >> 16)
    return torch.stack([b, g, r], -1).clamp(0, 255).to(torch.uint8)


def ycc_to_bgr(planes: Sequence[torch.Tensor],
               factors: Sequence[Tuple[int, int]], height: int, width: int,
               color: int = 1) -> torch.Tensor:
    """[height, width, 3] uint8 BGR from three uint8 component planes at
    their real sizes: the C2 kernel on CUDA tensors (it raises where it
    does not build or launch), the plain version on CPU tensors."""
    _check(planes, factors, height, width, color)
    if planes[0].device.type != "cuda":
        return ycc_to_bgr_plain(planes, factors, height, width, color)
    from .. import native

    lib = native.ycc_library()
    planes = [p.contiguous() for p in planes]
    dims = (ctypes.c_int32 * 6)(*[d for p in planes for d in p.shape])
    expand = (ctypes.c_int32 * 6)(*[e for pair in _expansions(factors)
                                    for e in pair])
    out = torch.empty((height, width, 3), dtype=torch.uint8,
                      device=planes[0].device)
    stream = torch.cuda.current_stream(planes[0].device).cuda_stream
    rc = lib.mml_ycc_to_bgr(planes[0].data_ptr(), planes[1].data_ptr(),
                            planes[2].data_ptr(), dims, expand, height, width,
                            int(color == 2), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"the C2 kernel did not launch: CUDA error {rc}")
    return out
