"""The attention kernels: flash-attention forward and backward.

Counterpart of the JAX package's `ops/attention_kernels.py`.  Three
Pallas TPU kernels of `mmlspark_tpu/ops/attention_kernels.py` become
CUDA kernels written by hand for Hopper, built for `sm_90a` and bound
with ctypes (ops/_build.py):

* B4 `_attention_pallas` (`pallas_call` at L196), the forward:
  `csrc/flash_attention_fwd.cu`, wrapper `flash_attention_fwd`;
* B5 `_attention_bwd_dkdv` (L278) and B6 `_attention_bwd_dq` (L348), the
  backward: `csrc/flash_attention_bwd.cu`, wrappers
  `flash_attention_bwd_dkdv` and `flash_attention_bwd_dq`.

The sources explain the designs; in short, at the shapes the
transformers give them (S of a few hundred to a thousand, D = 64) they
are bound by bytes on an H100 and keep every score block on chip: the
forward writes O and the logsumexp, the backward recomputes each score
block from that logsumexp.  B4, B5 and B6 take bf16 with D <= 128
(every main path) through kernels built for Hopper — TMA loads into a
ring of shared-memory stages on mbarriers, a producer warpgroup, wgmma
products — and f32, or bf16 with D > 128, through the earlier mma.sync /
FMA kernels; the C entry picks the kernel by dtype and D alone.  B5 and
B6 stay two passes, each gradient element summed by one thread in a
fixed order, so gradients are reproducible bit for bit.

Unlike the TPU wrappers they read q/k/v/dO in the model's (B, S, H, D)
layout through their strides — no transposes to [B*H, S, D], no padding
of S to the block grid or of D to the lane width, no lane-broadcast
lse/delta — and they decline nothing for reasons of tiling: any S, any D
up to 256 (a multiple of 8 for bf16).

Each wrapper takes its kernel for CUDA tensors and its plain PyTorch
version for CPU tensors; there is no other selection.  `LAUNCHES`,
`LAUNCHES_BWD_DKDV` and `LAUNCHES_BWD_DQ` count the kernels' launches.

`fused_attention` is differentiable (`_FlashAttention`, the counterpart
of the JAX package's `fused_attention.defvjp`): its forward runs B4 and
keeps O and the logsumexp, its backward computes delta = rowsum(dO * O)
with one PyTorch op and runs B5 then B6.  Under `torch.no_grad` /
`inference_mode` only the forward runs.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..parallel.ring_attention import attention_with_lse

__all__ = ["fused_attention", "kernel_ok", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_dkdv",
           "flash_attention_bwd_dkdv_plain", "flash_attention_bwd_dq",
           "flash_attention_bwd_dq_plain", "LAUNCHES", "LAUNCHES_BWD_DKDV",
           "LAUNCHES_BWD_DQ", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256  # the largest D the kernels instantiate

# kernel launches since import (or since a caller reset them to 0)
LAUNCHES = 0            # B4, the forward
LAUNCHES_BWD_DKDV = 0   # B5
LAUNCHES_BWD_DQ = 0     # B6


def kernel_ok(q) -> bool:
    """The static shape rule (the JAX package's `kernel_ok`, resized to
    what these kernels take): will a (B, S, H, D) array of this dtype and
    head dim take B4/B5/B6 on the card?  bf16 or f32, D <= 256, and a
    bf16 D a multiple of 8.  Callers that have a dense path (the ring,
    Ulysses) choose by this rule, never by catching a launch error."""
    d = q.shape[-1]
    if q.dtype not in (torch.bfloat16, torch.float32) or d > MAX_HEAD_DIM:
        return False
    return q.dtype != torch.bfloat16 or d % 8 == 0


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


def _check_bwd(q, k, v, do, lse, delta) -> None:
    """The backward's inputs: dO like q; lse and delta f32 [B*H, S]."""
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q: {tuple(do.shape)} {do.dtype} on "
                         f"{do.device}, q {tuple(q.shape)} {q.dtype}")
    b, s, h, _d = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b * h, s) or x.dtype != torch.float32 or \
                x.device != q.device:
            raise ValueError(f"{name} must be f32 [B*H, S] = [{b * h}, {s}] "
                             f"on {q.device}, got {tuple(x.shape)} {x.dtype}")


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of B4: dense `full_attention` and its
    logsumexp (the CPU path, and the kernel's oracle on the card)."""
    _check(q, k, v)
    return attention_with_lse(q, k, v, causal)


def _bwd_scores(q, k, v, do, lse, delta, causal
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, ds), f32 [B, H, S, S], as the backward kernels recompute them:
    p = exp(scale * q.k - lse) on the visible entries and 0 elsewhere,
    dp = dO.v in f32, ds = p * (dp - delta) * scale."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(sc - lse.reshape(b, h, s, 1))
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.reshape(b, h, s, 1)) * scale


def flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal: bool
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of B5: (dK, dV), f32 (B, S, H, D), with p
    rounded to dO's dtype before dV and ds to q's before dK, as the
    kernels round them (the CPU path, and the kernel's oracle)."""
    _check_bwd(q, k, v, do, lse, delta)
    p, ds = _bwd_scores(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.contiguous(), dv.contiguous()


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool
                                 ) -> torch.Tensor:
    """The plain PyTorch version of B6: dQ, f32 (B, S, H, D), with ds
    rounded to k's dtype before the product."""
    _check_bwd(q, k, v, do, lse, delta)
    _p, ds = _bwd_scores(q, k, v, do, lse, delta, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                        k.float()).contiguous()


def _fwd_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.library("flash_attention_fwd")
    fn = lib.mmk_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.library("flash_attention_bwd")
    for fn, n_out in ((lib.mmk_flash_attention_bwd_dkdv, 2),
                      (lib.mmk_flash_attention_bwd_dq, 1)):
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * (6 + n_out)
                           + [ctypes.c_int] * 5
                           + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                              ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(who: str, named) -> None:
    """What the kernels read: CUDA bf16 or f32 (B, S, H, D) views with
    D <= 256 (bf16: a multiple of 8), a unit-stride head dim and, for
    bf16, 16-byte-aligned rows (their loads are 16 bytes wide)."""
    x0 = named[0][1]
    if x0.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x0.device}")
    if x0.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{who}: expected bfloat16 or float32, got {x0.dtype}")
    d = x0.shape[-1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{who}: head dim {d} > {MAX_HEAD_DIM}")
    if x0.dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"{who}: bf16 head dim {d} is not a multiple of 8")
    for name, x in named:
        if x.stride(-1) != 1:
            raise ValueError(f"{who}: {name} must be contiguous in its last "
                             f"(head) dim, got strides {x.stride()}")
        if x.dtype == torch.bfloat16 and (
                x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3])):
            raise ValueError(
                f"{who}: bf16 {name} needs a 16-byte-aligned base and "
                f"strides that are multiples of 8, got strides {x.stride()}")


def _raise_on(who: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {err}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) q, k, v -> (O (B, S, H, D) f32, lse [B*H, S] f32):
    B4 for CUDA tensors, the plain version for CPU tensors.

    The kernel takes bf16 or f32 with D <= 256 (bf16: D a multiple of 8)
    and raises on anything else; it never falls back."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    _check_kernel_inputs("flash_attention_fwd", (("q", q), ("k", k), ("v", v)))
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    lib = _fwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmk_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), b, s, h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
            1.0 / math.sqrt(d), stream)
    _raise_on("flash_attention_fwd", err)
    LAUNCHES += 1
    return out, lse


def _launch_bwd(who: str, entry: str, q, k, v, do, lse, delta, outs,
                causal: bool) -> None:
    """One backward kernel on the current stream, writing `outs`."""
    _check_kernel_inputs(who, (("q", q), ("k", k), ("v", v), ("dO", do)))
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError(f"{who}: lse and delta must be contiguous")
    b, s, h, d = q.shape
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *do.stride()[:3])
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            int(q.dtype == torch.bfloat16), b, s, h, d, strides, int(causal),
            1.0 / math.sqrt(d), stream)
    _raise_on(who, err)


def flash_attention_bwd_dkdv(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, delta: torch.Tensor,
                             causal: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) q, k, v, dO (one dtype), f32 [B*H, S] lse and delta ->
    (dK, dV), f32 (B, S, H, D): B5 for CUDA tensors, the plain version for
    CPU tensors.  Takes what B4 takes and raises on anything else."""
    global LAUNCHES_BWD_DKDV
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal)
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch_bwd("flash_attention_bwd_dkdv", "mmk_flash_attention_bwd_dkdv",
                q, k, v, do, lse, delta, (dk, dv), causal)
    LAUNCHES_BWD_DKDV += 1
    return dk, dv


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           do: torch.Tensor, lse: torch.Tensor,
                           delta: torch.Tensor, causal: bool) -> torch.Tensor:
    """The same inputs -> dQ, f32 (B, S, H, D): B6 for CUDA tensors, the
    plain version for CPU tensors."""
    global LAUNCHES_BWD_DQ
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch_bwd("flash_attention_bwd_dq", "mmk_flash_attention_bwd_dq",
                q, k, v, do, lse, delta, (dq,), causal)
    LAUNCHES_BWD_DQ += 1
    return dq


class _FlashAttention(torch.autograd.Function):
    """`fused_attention` with the flash backward: B4 forward, B5 and B6
    backward (the JAX package's `_fused_attention_fwd` /
    `_flash_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        b, s, h, _d = q.shape
        # delta = rowsum(dO * O) over the true D, in f32, as the JAX
        # package computes it outside its kernels
        delta = torch.einsum("bshd,bshd->bhs", g.float(), out).reshape(
            b * h, s).contiguous()
        # the kernels read dO at the inputs' dtype (bf16 on the card) with
        # a unit-stride head dim; autograd may hand over any strides
        do = g.to(q.dtype).contiguous()
        dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, ctx.causal)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Drop-in for `full_attention`: (B, S, H, D) -> (B, S, H, D) f32,
    differentiable through the flash backward.  Without a gradient to
    record (`no_grad`, `inference_mode`, or inputs that need none) only
    the forward runs."""
    return _FlashAttention.apply(q, k, v, causal)
