"""The attention kernel: flash-attention forward.

Counterpart of the JAX package's `ops/attention_kernels.py`, forward
only.  It replaces the Pallas TPU kernel
`mmlspark_tpu/ops/attention_kernels.py::_attention_pallas` (`pallas_call`
at L196) with a CUDA kernel written by hand for Hopper,
`csrc/flash_attention_fwd.cu`, built for `sm_90a` and bound with ctypes
(ops/_build.py).  The source explains the design; in short, at the
shapes the transformers give it (S of a few hundred to a thousand,
D = 64) it is bound by bytes on an H100, and it keeps every score block
on chip: q, k and v are read once, O and the logsumexp written once.

Unlike the TPU wrapper it reads q/k/v in the model's (B, S, H, D) layout
through their strides — no transposes to [B*H, S, D], no padding of S to
the block grid or of D to the lane width — and it declines nothing for
reasons of tiling: any S, any D up to 256 (a multiple of 8 for bf16).

`flash_attention_fwd` takes the kernel for CUDA tensors and the plain
PyTorch version (`flash_attention_fwd_plain`, i.e. `full_attention`) for
CPU tensors; there is no other selection.  `LAUNCHES` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..parallel.ring_attention import attention_with_lse

__all__ = ["fused_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "LAUNCHES", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256  # the largest D csrc/flash_attention_fwd.cu instantiates

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected (B, S, H, D) q/k/v, got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v lie on different devices")


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: dense `full_attention`
    and its logsumexp (the CPU path, and the kernel's oracle on the card)."""
    _check(q, k, v)
    return attention_with_lse(q, k, v, causal)


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.library("flash_attention_fwd")
    fn = lib.mmk_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_kernel_input(name: str, x: torch.Tensor) -> None:
    """What the kernel reads: a unit-stride head dim and 16-byte-aligned
    rows (its loads are 16 bytes wide for bf16)."""
    if x.stride(-1) != 1:
        raise ValueError(f"flash_attention_fwd: {name} must be contiguous in "
                         f"its last (head) dim, got strides {x.stride()}")
    if x.dtype == torch.bfloat16:
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(
                f"flash_attention_fwd: bf16 {name} needs a 16-byte-aligned "
                f"base and strides that are multiples of 8, got strides "
                f"{x.stride()}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) q, k, v -> (O (B, S, H, D) f32, lse [B*H, S] f32):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    The kernel takes bf16 or f32 with D <= 256 (bf16: D a multiple of 8)
    and raises on anything else; it never falls back."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention_fwd: expected bfloat16 or float32, "
                        f"got {q.dtype}")
    b, s, h, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_fwd: head dim {d} > {MAX_HEAD_DIM}")
    if q.dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"flash_attention_fwd: bf16 head dim {d} is not a "
                         f"multiple of 8")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_kernel_input(name, x)
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmk_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), b, s, h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
            1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, lse


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Drop-in for `full_attention`: (B, S, H, D) -> (B, S, H, D) f32."""
    return flash_attention_fwd(q, k, v, causal)[0]
