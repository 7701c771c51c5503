"""Plain image arithmetic of the reference: a frozen copy of the
featurizer's resize and normalize, and PIL's bicubic resize.

`resize_normalize` is the arithmetic of the featurizer's preprocess (the
resize of `jax.image.resize`, "linear": half-pixel centres, the triangle
widened by the scale on a downscale, each output's weights normalised to
sum 1, an identity axis left alone; then `(x - mean) / std` per channel),
written here again in float32 so that a change to the program's copy
cannot move the yardstick.

`pil_bicubic_resize` is what `PIL.Image.resize((w, h))` does by default to
an RGB image (BICUBIC, a = -0.5, support 2 widened by the scale on a
downscale, a horizontal pass first and a vertical pass over the rows it
needs, each rounded to uint8 through 22-bit fixed-point weights), so that
it gives PIL's pixels exactly.  The fine-tuning stage resizes its training
rows so on the host; the reference derives those pixels again.

Imports nothing but numpy and torch.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["IMAGENET_MEAN_BGR", "IMAGENET_STD_BGR", "resize_weights",
           "resize_normalize", "pil_bicubic_resize"]

# ImageNet channel statistics in BGR order and 0-255 scale (the
# torchvision values, reordered): images arrive as BGR uint8 rows
IMAGENET_MEAN_BGR = (103.53, 116.28, 123.675)
IMAGENET_STD_BGR = (57.375, 57.12, 58.395)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 weights of an antialiased linear resize."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = np.maximum(0.0, 1.0 - dist / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total == 0, 1.0, total), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return np.ascontiguousarray(w.T, dtype=np.float32)


def resize_normalize(batch: torch.Tensor, h_out: int, w_out: int,
                     mean: Sequence[float] = IMAGENET_MEAN_BGR,
                     std: Sequence[float] = IMAGENET_STD_BGR) -> torch.Tensor:
    """uint8 [B, H, W, C] -> float32 [B, h_out, w_out, C], resized and
    normalised, on the batch's device."""
    dev = batch.device
    _, h, w, c = batch.shape
    a_h = torch.from_numpy(resize_weights(h, h_out)).to(dev)
    a_w = torch.from_numpy(resize_weights(w, w_out)).to(dev)
    x = batch.to(torch.float32)
    x = torch.einsum("yh,bhwc->bywc", a_h, x)
    x = torch.einsum("xw,bywc->byxc", a_w, x)
    m = torch.tensor(mean, dtype=torch.float32, device=dev)
    inv = (1.0 / torch.tensor(std, dtype=torch.float32)).to(dev)
    return (x - m) * inv


# ---- PIL's bicubic resize -------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coeffs(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first input index [n_out], fixed-point weights [n_out, ksize]) of
    one axis, computed as PIL's precompute_coeffs and
    normalize_coeffs_8bpc compute them (doubles, then rounded away from
    zero to 22 fractional bits)."""
    scale = filterscale = n_in / n_out
    if filterscale < 1.0:
        filterscale = 1.0
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(n_out, np.int64)
    kk = np.zeros((n_out, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)
        for x in range(xmax):
            v = w[x] / ww if ww != 0.0 else w[x]
            kk[xx, x] = (int(v * (1 << _PRECISION_BITS) + 0.5) if v >= 0
                         else int(v * (1 << _PRECISION_BITS) - 0.5))
        first[xx] = xmin
    return first, kk


def _pass(x: torch.Tensor, first: np.ndarray, kk: np.ndarray, axis: int
          ) -> torch.Tensor:
    """One 8-bit pass along `axis` of int64 pixels: the fixed-point sum
    with half added, shifted and clipped to 0..255."""
    n_in = x.shape[axis]
    shape = [1] * x.dim()
    shape[axis] = len(first)
    acc = None
    for j in range(kk.shape[1]):
        idx = torch.from_numpy(np.minimum(first + j, n_in - 1)).to(x.device)
        k = torch.from_numpy(kk[:, j].copy()).to(x.device).reshape(shape)
        term = x.index_select(axis, idx) * k
        acc = term if acc is None else acc.add_(term)
    return ((acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS).clamp_(
        0, 255)


def pil_bicubic_resize(images: torch.Tensor, h_out: int, w_out: int
                       ) -> torch.Tensor:
    """uint8 [B, H, W, C] -> uint8 [B, h_out, w_out, C] on the images'
    device, as PIL's default `Image.resize((w_out, h_out))` gives each
    image (channel order does not matter: every channel is resized
    alike)."""
    _, h, w, _ = images.shape
    x = images.to(torch.int64)
    # the horizontal pass first; PIL skips an axis whose size is kept
    if w != w_out:
        x = _pass(x, *_coeffs(w, w_out), axis=2)
    if h != h_out:
        x = _pass(x, *_coeffs(h, h_out), axis=1)
    return x.to(torch.uint8)
