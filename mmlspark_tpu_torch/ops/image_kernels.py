"""The image-preprocessing kernel: fused affine resample + normalize.

Counterpart of the JAX package's `ops/pallas_kernels.py` for the kernel
the ImageFeaturizer path runs.  It replaces the Pallas TPU kernel
`mmlspark_tpu/ops/pallas_kernels.py::_fused_resize_normalize_run`
(`pallas_call` at L164) with a CUDA kernel written by hand for Hopper,
`csrc/resize_normalize.cu`, built for `sm_90a` and bound with ctypes
(ops/_build.py).  The source explains the design; in short, the kernel
is bound by bytes on an H100 — one uint8 read of the input and one f32
write of the output per pixel — and computes each output pixel from the
few non-zero taps the host found for its row and column, instead of the
TPU's dense padded matmuls.

The contract is the general affine one of the TPU kernel:

    out[b, y, x, co] = (sum_ci C[ci, co] * (A_h @ X[b, :, :, ci] @ A_w^T)[y, x]
                        - mean_eff[co]) * inv_eff[co]

for a uint8 or f32 NHWC batch X, with f32 NHWC output.  An `AffinePlan`
holds the host-built constants.  `fused_resize_normalize` builds the plan
of a linear resize (identity channel mix), so the later ImageTransformer
chains can reuse the kernel unchanged.

`affine_resample` takes the kernel for a CUDA tensor and the plain
PyTorch version (`affine_resample_plain`, same arithmetic in einsums)
for a CPU tensor; there is no other selection.  `LAUNCHES` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .image import resize_weights

__all__ = ["AffinePlan", "resize_plan", "fused_resize_normalize",
           "affine_resample", "affine_resample_plain", "LAUNCHES"]

MAX_CHANNELS = 4  # kMaxChannels of csrc/resize_normalize.cu

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _tap_ranges(a: np.ndarray) -> np.ndarray:
    """[n_out, 2] int32 [lo, hi) of each row's non-zero weights."""
    rng = np.zeros((a.shape[0], 2), np.int32)
    for r, row in enumerate(a):
        nz = np.flatnonzero(row)
        if nz.size:
            rng[r] = (nz[0], nz[-1] + 1)
    return rng


class AffinePlan:
    """Host-built constants of one affine resample: the height and width
    weights `a_h [h_out, h_in]` / `a_w [w_out, w_in]`, the channel mix
    `cmix [c_in, c_out]`, the normalize epilogue `mean_eff`/`inv_eff
    [c_out]` (all f32), and each output row's and column's [lo, hi) tap
    range.  Device copies are made once per device."""

    def __init__(self, a_h, a_w, cmix, mean_eff, inv_eff):
        self.a_h = np.ascontiguousarray(a_h, np.float32)
        self.a_w = np.ascontiguousarray(a_w, np.float32)
        self.cmix = np.ascontiguousarray(cmix, np.float32)
        self.mean_eff = np.ascontiguousarray(mean_eff, np.float32)
        self.inv_eff = np.ascontiguousarray(inv_eff, np.float32)
        self.h_out, self.h_in = self.a_h.shape
        self.w_out, self.w_in = self.a_w.shape
        self.c_in, self.c_out = self.cmix.shape
        if self.mean_eff.shape != (self.c_out,) or \
                self.inv_eff.shape != (self.c_out,):
            raise ValueError("mean_eff/inv_eff must have c_out entries")
        self.y_rng = _tap_ranges(self.a_h)
        self.x_rng = _tap_ranges(self.a_w)
        self._dev: Dict[str, Tuple[torch.Tensor, ...]] = {}

    def tensors(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """(a_h, a_w, cmix, mean_eff, inv_eff, y_rng, x_rng) on `device`."""
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = tuple(torch.from_numpy(a).to(device) for a in (
                self.a_h, self.a_w, self.cmix, self.mean_eff, self.inv_eff,
                self.y_rng, self.x_rng))
            self._dev[key] = t
        return t


@lru_cache(maxsize=16)
def resize_plan(h_in: int, w_in: int, c: int, h_out: int, w_out: int,
                mean: Tuple[float, ...], std: Tuple[float, ...]) -> AffinePlan:
    """The plan of a linear resize to (h_out, w_out) + per-channel
    normalize (identity channel mix) — `_resize_consts` of the JAX
    package without its TPU tile padding."""
    return AffinePlan(resize_weights(h_in, h_out), resize_weights(w_in, w_out),
                      np.eye(c, dtype=np.float32), np.asarray(mean, np.float32),
                      (1.0 / np.asarray(std, np.float32)).astype(np.float32))


def fused_resize_normalize(batch: torch.Tensor, h_out: int, w_out: int,
                           mean: Sequence[float] = (0.0,),
                           std: Sequence[float] = (1.0,)) -> torch.Tensor:
    """uint8/f32 [B,H,W,C] -> f32 [B,h_out,w_out,C]: cast + linear resize
    (jax.image.resize semantics) + per-channel normalize in one pass.
    Identity sizes go through the same kernel with one tap per axis."""
    c = batch.shape[-1]
    mean = tuple(float(m) for m in np.broadcast_to(np.asarray(mean), (c,)))
    std = tuple(float(s) for s in np.broadcast_to(np.asarray(std), (c,)))
    plan = resize_plan(int(batch.shape[1]), int(batch.shape[2]), int(c),
                       int(h_out), int(w_out), mean, std)
    return affine_resample(batch, plan)


def _check(batch: torch.Tensor, plan: AffinePlan) -> None:
    if batch.dim() != 4:
        raise ValueError(f"expected an NHWC batch, got shape {tuple(batch.shape)}")
    if batch.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"expected uint8 or float32, got {batch.dtype}")
    if tuple(batch.shape[1:]) != (plan.h_in, plan.w_in, plan.c_in):
        raise ValueError(f"batch {tuple(batch.shape)} does not match the "
                         f"plan's input {(plan.h_in, plan.w_in, plan.c_in)}")


def affine_resample_plain(batch: torch.Tensor, plan: AffinePlan) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same contraction as
    einsums in f32 (the CPU path, and the kernel's oracle on the card)."""
    _check(batch, plan)
    a_h, a_w, cmix, mean, inv = plan.tensors(batch.device)[:5]
    x = batch.to(torch.float32)
    t = torch.einsum("yh,bhwc->bywc", a_h, x)
    u = torch.einsum("xw,bywc->byxc", a_w, t)
    v = torch.einsum("byxc,cd->byxd", u, cmix)
    return (v - mean) * inv


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.library("resize_normalize")
    fn = lib.mmk_affine_resample
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 8)
        fn.restype = ctypes.c_int
    return lib


def affine_resample(batch: torch.Tensor, plan: AffinePlan) -> torch.Tensor:
    """Run the plan over `batch`: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    global LAUNCHES
    _check(batch, plan)
    if batch.device.type == "cpu":
        return affine_resample_plain(batch, plan)
    if batch.device.type != "cuda":
        raise ValueError(f"affine_resample: unsupported device {batch.device}")
    if not batch.is_contiguous():
        raise ValueError("affine_resample: the batch must be contiguous NHWC")
    if plan.c_in > MAX_CHANNELS or plan.c_out > MAX_CHANNELS:
        raise ValueError(f"affine_resample: at most {MAX_CHANNELS} channels")
    n = batch.shape[0]
    out = torch.empty((n, plan.h_out, plan.w_out, plan.c_out),
                      dtype=torch.float32, device=batch.device)
    a_h, a_w, cmix, mean, inv, y_rng, x_rng = plan.tensors(batch.device)
    lib = _kernel_lib()
    with torch.cuda.device(batch.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmk_affine_resample(
            batch.data_ptr(), int(batch.dtype == torch.uint8), out.data_ptr(),
            n, plan.h_in, plan.w_in, plan.c_in, plan.h_out, plan.w_out,
            plan.c_out, a_h.data_ptr(), a_w.data_ptr(), y_rng.data_ptr(),
            x_rng.data_ptr(), cmix.data_ptr(), mean.data_ptr(),
            inv.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"affine_resample kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
