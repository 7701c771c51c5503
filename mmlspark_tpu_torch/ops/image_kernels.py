"""The image-preprocessing kernels: B1, the fused affine resample +
normalize, and B2, the fused normalize + HWC->CHW unroll.

Counterpart of the JAX package's `ops/pallas_kernels.py`.  B1
replaces the Pallas TPU kernel
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
kernel's launches.  `build_affine_pipeline` / `affine_plan` compose an
ImageTransformer op chain into one plan for it.

B2 replaces `_fused_normalize_unroll_pallas` (`pallas_call` at L56) with
`csrc/normalize_unroll.cu`: `fused_normalize_unroll` (the kernel for a
CUDA tensor, `fused_normalize_unroll_plain` for a CPU tensor) is
UnrollImage's f32 [B,H,W,C] -> [B, C*H*W] with (x - mean) * (1/std) per
channel; `LAUNCHES_UNROLL` counts its launches.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .image import gaussian_kernel, resize_weights, _BGR2GRAY

__all__ = ["AffinePlan", "resize_plan", "fused_resize_normalize",
           "affine_resample", "affine_resample_plain", "LAUNCHES",
           "build_affine_pipeline", "freeze_stages", "affine_plan",
           "fused_affine_apply", "fused_normalize_unroll",
           "fused_normalize_unroll_plain", "LAUNCHES_UNROLL"]

MAX_CHANNELS = 4  # kMaxChannels of csrc/resize_normalize.cu and normalize_unroll.cu

# kernel launches since import (or since a caller reset it to 0): B1's
# and B2's
LAUNCHES = 0
LAUNCHES_UNROLL = 0


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


# ---------------------------------------------------------------------------
# Fused affine image chains: every separable-linear ImageTransformer op
# (crop / linear resize / flip / blur / colour conversion / a trailing
# normalize) is a per-axis matrix or a channel mix, so a whole op chain
# composes into one AffinePlan and runs as one launch of the resample
# kernel above — one read of the uint8 batch and one f32 write for the
# whole chain.  The counterpart of pallas_kernels.py:274-462 without its
# TPU rules (the VMEM gate and the (8, 128) padding of `_affine_consts`).
# ---------------------------------------------------------------------------

def _color_mats():
    """Channel-mixing matrices matching ops.image.color_convert exactly
    (gray weights from the same _BGR2GRAY constant)."""
    gray_bgr = np.asarray(_BGR2GRAY, np.float64).reshape(3, 1)
    return {
        "bgr2rgb": np.eye(3)[:, ::-1],
        "rgb2bgr": np.eye(3)[:, ::-1],
        "bgr2gray": gray_bgr,
        "rgb2gray": gray_bgr[::-1],
        "gray2bgr": np.ones((1, 3)),
        "gray2rgb": np.ones((1, 3)),
    }


def _conv_same_matrix(n: int, k1d: np.ndarray) -> np.ndarray:
    """[n, n] zero-padded SAME-correlation (Toeplitz) matrix matching
    lax.conv SAME semantics: pad_low = (k-1)//2."""
    k = len(k1d)
    pad_low = (k - 1) // 2
    t = np.zeros((n, n), np.float64)
    for i in range(n):
        for tap in range(k):
            j = i + tap - pad_low
            if 0 <= j < n:
                t[i, j] += k1d[tap]
    return t


def build_affine_pipeline(stages, h_in: int, w_in: int, c_in: int):
    """Compose an ImageTransformer op list into f32 (A_h, A_w, C, mean,
    inv) with out = (C-mix of A_h @ X @ A_w^T - mean) * inv.  None when
    the chain is not expressible (an op after normalize, threshold, a
    non-linear resize, an unknown op, scale == 0) or is view-only
    (flip / crop / colour swap, cheaper as views than as a resample)."""
    a_h = np.eye(h_in, dtype=np.float64)
    a_w = np.eye(w_in, dtype=np.float64)
    cmat = np.eye(c_in, dtype=np.float64)
    h, w, c = h_in, w_in, c_in
    mean = None
    std = None
    scale = 1.0
    mixing = False  # a real interpolation or filter in the chain
    for name, kw in stages or []:
        if mean is not None:
            return None  # ops after normalize: the plain composition
        if name == "resize":
            if kw.get("method", "linear") != "linear":
                return None
            nh, nw = int(kw["height"]), int(kw["width"])
            mixing = mixing or nh != h or nw != w
            a_h = resize_weights(h, nh).astype(np.float64) @ a_h
            a_w = resize_weights(w, nw).astype(np.float64) @ a_w
            h, w = nh, nw
        elif name in ("crop", "centerCrop"):
            ch_, cw = int(kw["height"]), int(kw["width"])
            if name == "crop":
                y0, x0 = int(kw["y"]), int(kw["x"])
            else:
                y0, x0 = max((h - ch_) // 2, 0), max((w - cw) // 2, 0)
            a_h = a_h[y0:y0 + ch_]
            a_w = a_w[x0:x0 + cw]
            h, w = a_h.shape[0], a_w.shape[0]
        elif name == "flip":
            if kw.get("flipLeftRight", True):
                a_w = a_w[::-1]
            if kw.get("flipUpDown", False):
                a_h = a_h[::-1]
        elif name == "blur":
            kh, kw_ = int(kw["height"]), int(kw["width"])
            a_h = _conv_same_matrix(h, np.full(kh, 1.0 / kh)) @ a_h
            a_w = _conv_same_matrix(w, np.full(kw_, 1.0 / kw_)) @ a_w
            mixing = True
        elif name == "gaussianKernel":
            k2d = gaussian_kernel(int(kw["apertureSize"]), float(kw["sigma"]))
            # gaussian_kernel is outer(g, g): recover the separable 1-D taps
            g = np.sqrt(np.diag(k2d.astype(np.float64)))
            a_h = _conv_same_matrix(h, g) @ a_h
            a_w = _conv_same_matrix(w, g) @ a_w
            mixing = True
        elif name == "colorFormat":
            m = _color_mats().get(kw["format"].lower())
            if m is None or m.shape[0] != c:
                return None
            cmat = cmat @ m
            c = m.shape[1]
        elif name == "normalize":
            scale = float(kw.get("scale", 1.0))
            if scale == 0.0:
                # (u*0 - mean)/std is constant, which the
                # (u - mean/scale)*(scale/std) folding cannot express
                return None
            mean = np.broadcast_to(np.asarray(kw["mean"], np.float64), (c,))
            std = np.broadcast_to(np.asarray(kw["std"], np.float64), (c,))
        else:
            return None  # threshold and anything unknown
    if not mixing:
        return None
    if mean is None:
        mean = np.zeros(c)
        std = np.ones(c)
    # (u*scale - mean)/std == (u - mean/scale) * (scale/std)
    return (a_h.astype(np.float32), a_w.astype(np.float32),
            cmat.astype(np.float32), (mean / scale).astype(np.float32),
            (scale / std).astype(np.float32))


def freeze_stages(stages) -> tuple:
    """Hashable form of an ImageTransformer op list (lists -> tuples)."""

    def fz(v):
        if isinstance(v, np.ndarray):
            return tuple(v.tolist())
        if isinstance(v, (list, tuple)):
            return tuple(fz(x) for x in v)
        return v

    return tuple((name, tuple(sorted((k, fz(v)) for k, v in kw.items())))
                 for name, kw in (stages or []))


@lru_cache(maxsize=16)
def affine_plan(frozen_stages: tuple, h_in: int, w_in: int, c_in: int):
    """The AffinePlan of a frozen op list at one input shape, or None when
    the chain does not fuse (see build_affine_pipeline) or has more
    channels than the kernel takes.  Cached: a plan keeps its device
    copies, and a param mutation changes the key."""
    consts = build_affine_pipeline(
        [(name, dict(kw)) for name, kw in frozen_stages], h_in, w_in, c_in)
    if consts is None:
        return None
    plan = AffinePlan(*consts)
    if plan.c_in > MAX_CHANNELS or plan.c_out > MAX_CHANNELS:
        return None
    return plan


def fused_affine_apply(batch: torch.Tensor, plan: AffinePlan) -> torch.Tensor:
    """Run a composed chain's plan over [B,H,W,C]: one resample launch on
    the card, its plain version on the CPU."""
    return affine_resample(batch, plan)


# ---------------------------------------------------------------------------
# B2: fused normalize + HWC->CHW unroll (UnrollImage), the counterpart of
# pallas_kernels.py::_fused_normalize_unroll_pallas; the kernel is
# csrc/normalize_unroll.cu (its source explains the design).
# ---------------------------------------------------------------------------

def _unroll_consts(c: int, mean, std) -> Tuple[np.ndarray, np.ndarray]:
    """f32 mean and inv = float32(1/std) of length c (a length-1 mean or
    std broadcasts), the reciprocal taken in double as the JAX kernel's
    host code takes it."""
    mean = np.broadcast_to(np.asarray(mean, np.float64), (c,))
    std = np.broadcast_to(np.asarray(std, np.float64), (c,))
    return (np.ascontiguousarray(mean, np.float32),
            np.ascontiguousarray(1.0 / std, np.float32))


def _check_unroll(batch: torch.Tensor) -> None:
    if batch.dim() != 4:
        raise ValueError(f"expected an NHWC batch, got shape {tuple(batch.shape)}")
    if batch.dtype != torch.float32:
        raise TypeError(f"fused_normalize_unroll: expected float32, got {batch.dtype}")


def fused_normalize_unroll_plain(batch: torch.Tensor,
                                 mean: Sequence[float] = (0.0,),
                                 std: Sequence[float] = (1.0,)) -> torch.Tensor:
    """The plain PyTorch version of B2: ((x - mean) * inv) in f32, then
    CHW-flat (the CPU path, and the kernel's oracle on the card)."""
    _check_unroll(batch)
    b, c = batch.shape[0], batch.shape[3]
    mean_np, inv_np = _unroll_consts(c, mean, std)
    mean_t = torch.from_numpy(mean_np).to(batch.device)
    inv_t = torch.from_numpy(inv_np).to(batch.device)
    return ((batch - mean_t) * inv_t).permute(0, 3, 1, 2).reshape(b, -1)


def _unroll_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.library("normalize_unroll")
    fn = lib.mmk_normalize_unroll
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fused_normalize_unroll(batch: torch.Tensor,
                           mean: Sequence[float] = (0.0,),
                           std: Sequence[float] = (1.0,)) -> torch.Tensor:
    """f32 [B,H,W,C] -> f32 [B, C*H*W]: per-channel (x - mean) * (1/std)
    and the HWC->CHW unroll in one pass — the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    global LAUNCHES_UNROLL
    _check_unroll(batch)
    if batch.device.type == "cpu":
        return fused_normalize_unroll_plain(batch, mean, std)
    if batch.device.type != "cuda":
        raise ValueError(f"fused_normalize_unroll: unsupported device {batch.device}")
    if not batch.is_contiguous():
        raise ValueError("fused_normalize_unroll: the batch must be contiguous NHWC")
    b, h, w, c = batch.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"fused_normalize_unroll: at most {MAX_CHANNELS} channels")
    mean_np, inv_np = _unroll_consts(c, mean, std)
    out = torch.empty((b, c * h * w), dtype=torch.float32, device=batch.device)
    lib = _unroll_lib()
    with torch.cuda.device(batch.device):
        stream = torch.cuda.current_stream().cuda_stream
        # mean and inv are host arrays: the C entry passes them to the
        # kernel by value
        err = lib.mmk_normalize_unroll(
            batch.data_ptr(), out.data_ptr(), b, h * w, c,
            mean_np.ctypes.data, inv_np.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_normalize_unroll kernel launch failed: CUDA error {err}")
    LAUNCHES_UNROLL += 1
    return out
