"""Batched image ops over `[B, H, W, C]` float tensors: the OpenCV
replacement.

Counterpart of the JAX package's `ops/image.py`.  Reference:
opencv/.../ImageTransformer.scala:27-219 — ResizeImage, CropImage,
ColorFormat (cvtColor), Flip, Blur, Threshold, GaussianKernel applied
via OpenCV Mats per row.  Here every op is an eager PyTorch function of
a batch, on whatever device the batch lies; `ops/image_stages.py` chains
them (the plain composition) or folds a separable-linear chain into one
launch of the resample kernel (`ops/image_kernels.py`).  Images arrive
BGR uint8 (as Spark image rows do); gray conversion uses the BT.601
weights OpenCV uses.

`resize` reproduces `jax.image.resize` (antialiased, half-pixel
centres): linear and cubic as the weight matrices `resize_weights`
builds (jax/_src/image/scale.py `compute_weight_mat`), nearest as its
`_resize_nearest` indexes.  `torch.nn.functional.interpolate` is not
used: its weights are not defined to match.  The blurs are same-padded
depthwise correlations (pad_low = (k-1)//2, as `lax.conv` SAME), summed
tap by tap in f32, so no TF32 convolution can change them on the card.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = [
    "resize_weights",
    "resize",
    "center_crop",
    "crop",
    "flip",
    "color_convert",
    "gaussian_kernel",
    "gaussian_blur",
    "box_blur",
    "threshold",
    "normalize",
    "hwc_to_chw_flat",
    "chw_flat_to_hwc",
]


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel (a = -0.5), as scale.py writes it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, method: str = "linear"
                   ) -> np.ndarray:
    """[n_out, n_in] f32 resize weights of `jax.image.resize` (half-pixel
    centres, the kernel widened by the scale on downscale, each output's
    weights normalised to sum 1) for `method` "linear" (triangle) or
    "cubic" (Keys).  Identity sizes give the identity: `jax.image.resize`
    leaves such an axis alone."""
    if method not in _KERNELS:
        raise ValueError(f"no resize weights for method {method!r}")
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)  # antialias widens on downscale
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = _KERNELS[method](x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps,
                 w / np.where(total == 0, 1.0, total), 0.0)
    # samples outside the input range get no weight (never the case for
    # a plain resize, kept as scale.py has it)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return np.ascontiguousarray(w.T, dtype=np.float32)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """`_resize_nearest`'s source index of each output, computed in f32
    as scale.py computes it."""
    off = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
           * np.float32(n_in)) / np.float32(n_out)
    return np.floor(off).astype(np.int64)


def resize(batch: torch.Tensor, height: int, width: int,
           method: str = "linear") -> torch.Tensor:
    """Resize [B,H,W,C] to (height, width) as `jax.image.resize` does
    (ImageTransformer ResizeImage, ImageTransformer.scala:127-146;
    core/image/ResizeImageTransformer.scala).  Method "linear", "cubic"
    or "nearest"."""
    _, h, w, _ = batch.shape
    if method == "nearest":
        if h != height:
            batch = batch[:, torch.from_numpy(
                _nearest_index(h, height)).to(batch.device)]
        if w != width:
            batch = batch[:, :, torch.from_numpy(
                _nearest_index(w, width)).to(batch.device)]
        return batch
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    x = batch if batch.is_floating_point() else batch.to(torch.float32)
    if h != height:
        a_h = torch.from_numpy(resize_weights(h, height, method)).to(x)
        x = torch.einsum("yh,bhwc->bywc", a_h, x)
    if w != width:
        a_w = torch.from_numpy(resize_weights(w, width, method)).to(x)
        x = torch.einsum("xw,bywc->byxc", a_w, x)
    return x


def crop(batch: torch.Tensor, x: int, y: int, width: int, height: int
         ) -> torch.Tensor:
    """Rectangular crop at (x, y) — ImageTransformer CropImage (:148-166)."""
    return batch[:, y:y + height, x:x + width, :]


def center_crop(batch: torch.Tensor, height: int, width: int) -> torch.Tensor:
    _, h, w, _ = batch.shape
    y = max((h - height) // 2, 0)
    x = max((w - width) // 2, 0)
    return crop(batch, x, y, width, height)


def flip(batch: torch.Tensor, flip_left_right: bool = True,
         flip_up_down: bool = False) -> torch.Tensor:
    """ImageTransformer Flip (:186-199); ImageSetAugmenter uses both."""
    if flip_left_right:
        batch = torch.flip(batch, dims=(2,))
    if flip_up_down:
        batch = torch.flip(batch, dims=(1,))
    return batch


# BT.601 luma weights in BGR channel order (OpenCV default layout) — the
# JAX package's `_BGR2GRAY`, as f32
_BGR2GRAY = np.array([0.114, 0.587, 0.299], np.float32)


def color_convert(batch: torch.Tensor, mode: str) -> torch.Tensor:
    """bgr2rgb | rgb2bgr | bgr2gray | rgb2gray | gray2bgr — ImageTransformer
    ColorFormat (:168-184)."""
    mode = mode.lower()
    if mode in ("bgr2rgb", "rgb2bgr"):
        return torch.flip(batch, dims=(3,))
    if mode in ("bgr2gray", "rgb2gray"):
        w = _BGR2GRAY if mode == "bgr2gray" else _BGR2GRAY[::-1].copy()
        return (batch * torch.from_numpy(w).to(batch)).sum(-1, keepdim=True)
    if mode in ("gray2bgr", "gray2rgb"):
        return batch.repeat(1, 1, 1, 3)
    raise ValueError(f"unknown color mode {mode!r}")


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """2-D Gaussian kernel matching cv2.getGaussianKernel semantics
    (ImageTransformer GaussianKernel stage, :201-219)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    ax = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_same(batch: torch.Tensor, kernel2d: np.ndarray) -> torch.Tensor:
    """Same-padded per-channel 2-D correlation of [B,H,W,C] with one
    [kh, kw] kernel: `lax.conv_general_dilated(padding="SAME")`'s
    zero padding, pad_low = (k-1)//2 on each axis."""
    kh, kw = kernel2d.shape
    _, h, w, _ = batch.shape
    top, left = (kh - 1) // 2, (kw - 1) // 2
    padded = torch.nn.functional.pad(
        batch, (0, 0, left, kw - 1 - left, top, kh - 1 - top))
    out = torch.zeros_like(batch)
    for i in range(kh):
        for j in range(kw):
            out = out + padded[:, i:i + h, j:j + w, :] * float(kernel2d[i, j])
    return out


def gaussian_blur(batch: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur analog."""
    return _depthwise_same(batch, gaussian_kernel(ksize, sigma))


def box_blur(batch: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """cv2.blur analog — ImageTransformer Blur (:96-110)."""
    return _depthwise_same(batch, np.full((kh, kw), 1.0 / (kh * kw),
                                          dtype=np.float32))


def threshold(batch: torch.Tensor, thresh: float, max_val: float,
              kind: str = "binary") -> torch.Tensor:
    """cv2.threshold analog — ImageTransformer Threshold (:112-125)."""
    kind = kind.lower()
    zero = torch.zeros((), dtype=batch.dtype, device=batch.device)
    top = torch.full((), max_val, dtype=batch.dtype, device=batch.device)
    if kind == "binary":
        return torch.where(batch > thresh, top, zero)
    if kind == "binary_inv":
        return torch.where(batch > thresh, zero, top)
    if kind == "trunc":
        return torch.clamp(batch, max=thresh)
    if kind == "tozero":
        return torch.where(batch > thresh, batch, zero)
    if kind == "tozero_inv":
        return torch.where(batch > thresh, zero, batch)
    raise ValueError(f"unknown threshold kind {kind!r}")


def normalize(batch: torch.Tensor, mean: Sequence[float],
              std: Sequence[float], scale: float = 1.0) -> torch.Tensor:
    """(x*scale - mean)/std channelwise — the normalize tail of every DL
    feed; it divides by std (the fused unroll multiplies by 1/std)."""
    mean_t = torch.as_tensor(np.asarray(mean, np.float64), dtype=batch.dtype,
                             device=batch.device)
    std_t = torch.as_tensor(np.asarray(std, np.float64), dtype=batch.dtype,
                            device=batch.device)
    return (batch * scale - mean_t) / std_t


def hwc_to_chw_flat(batch: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B, C*H*W] flat vector, CHW order — UnrollImage semantics
    (core/image/UnrollImage.scala:30-55: output index c*h*w layout)."""
    return batch.permute(0, 3, 1, 2).reshape(batch.shape[0], -1)


def chw_flat_to_hwc(flat: torch.Tensor, height: int, width: int,
                    channels: int) -> torch.Tensor:
    """Inverse of hwc_to_chw_flat — UnrollImage.roll (UnrollImage.scala)."""
    return flat.reshape(flat.shape[0], channels, height, width).permute(
        0, 2, 3, 1)
