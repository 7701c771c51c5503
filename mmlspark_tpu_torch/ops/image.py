"""Linear-resize weights, as the JAX package's `jax.image.resize` builds
them.

`resize_weights` is a copy of the JAX package's `_resize_weights_np`
(half-pixel centres, triangle kernel, antialiased on downscale).  The
resize+normalize kernel (`ops/image_kernels.py`) and its plain PyTorch
version both apply these weights, so the port reproduces
`jax.image.resize(method="linear")`.  `torch.nn.functional.interpolate`
is not used: its weights are not defined to match.
"""
from __future__ import annotations

import numpy as np

__all__ = ["resize_weights"]


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] numpy linear-interpolation weights, bit-matching
    jax.image.resize(method="linear") (half-pixel centers, triangle
    kernel, antialiased on downscale)."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)  # antialias widens on downscale
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = np.maximum(0.0, 1.0 - x / kernel_scale)     # triangle kernel
    total = w.sum(axis=0, keepdims=True)
    w = np.where(total > 0, w / np.where(total == 0, 1.0, total), 0.0)
    return np.ascontiguousarray(w.T, dtype=np.float32)
