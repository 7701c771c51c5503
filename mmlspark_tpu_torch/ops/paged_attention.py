"""The paged decode-attention kernels: one new token per slot over K/V
page pools addressed by a page table.

Counterpart of the JAX package's `ops/paged_attention.py`.  It replaces
the Pallas TPU kernels `mmlspark_tpu/ops/paged_attention.py::_paged_pallas`
(B7, `pallas_call` at L167) and `::_paged_pallas_int8` (B8, L250) with
CUDA kernels written by hand for Hopper, `csrc/paged_attention.cu`, built
for `sm_90a` and bound with ctypes (ops/_build.py).  The source explains
the design: one block per (slot, K/V head) walks only the slot's live
pages through the page table, which it reads in device memory; the
softmax and both products run in f32.

Shapes: q [B, H, D]; pools [NP, page, Hkv, D] with Hkv dividing H (query
head h reads pool head h // (H / Hkv), `jnp.repeat` semantics, so GQA
pools take the kernel too); B8's f32 scales [NP, page, Hkv]; page table
[B, MP] int32 whose entries are pages of the pool; pos [B] int32 -> f32
[B, H, D].  Any page size and MP, D up to 256 (bf16: a multiple of 8;
int8 pools: a multiple of 4).

`paged_decode_attention(_int8)` take the kernel for CUDA tensors and
the plain PyTorch version (`*_plain`, the semantics of the JAX package's
`_xla_paged` / `_xla_paged_int8`: gather every page of the table, mask
positions past pos, softmax) for CPU tensors; there is no other
selection.  `LAUNCHES` and `LAUNCHES_INT8` count the kernels' launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["paged_decode_attention", "paged_decode_attention_int8",
           "paged_decode_attention_plain", "paged_decode_attention_int8_plain",
           "gather_pages", "LAUNCHES", "LAUNCHES_INT8", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256  # the largest D csrc/paged_attention.cu takes

# kernel launches since import (or since a caller reset them to 0): B7, B8
LAUNCHES = 0
LAUNCHES_INT8 = 0


def _check(q, pools, scales, page_table, pos) -> None:
    """Shapes and devices, the same for both versions of both kernels."""
    if q.dim() != 3:
        raise ValueError(f"expected q [B, H, D], got {tuple(q.shape)}")
    b, h, d = q.shape
    shape = pools[0].shape
    if len(shape) != 4 or shape[3] != d:
        raise ValueError(f"expected pools [NP, page, Hkv, {d}], got "
                         f"{tuple(shape)}")
    if any(p.shape != shape for p in pools):
        raise ValueError(f"K/V pool shapes differ: "
                         f"{[tuple(p.shape) for p in pools]}")
    if shape[2] < 1 or h % shape[2]:
        raise ValueError(f"pool heads {shape[2]} must divide query heads {h}")
    if any(s.shape != shape[:3] for s in scales):
        raise ValueError(f"expected scales {tuple(shape[:3])}, got "
                         f"{[tuple(s.shape) for s in scales]}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"expected page_table [{b}, MP], got "
                         f"{tuple(page_table.shape)}")
    if pos.shape != (b,):
        raise ValueError(f"expected pos [{b}], got {tuple(pos.shape)}")
    tensors = (q, *pools, *scales, page_table, pos)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged attention inputs lie on different devices")


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Every page of each slot's table, pool [NP, page, ...] -> one
    logical [B, MP * page, ...] copy: slot b's position p is
    pool[page_table[b, p // page], p % page]."""
    b, mp = page_table.shape
    return pool[page_table.long()].reshape(b, mp * pool.shape[1],
                                           *pool.shape[2:])


def _gather(pool: torch.Tensor, page_table: torch.Tensor, h: int
            ) -> torch.Tensor:
    """`gather_pages`, its heads repeated up to h (`jnp.repeat`)."""
    x = gather_pages(pool, page_table)
    reps = h // pool.shape[2]
    return x if reps == 1 else torch.repeat_interleave(x, reps, dim=2)


def _masked_scores(q, k_log, pos, k_scale=None):
    b, h, d = q.shape
    sc = torch.einsum("bhd,bkhd->bhk", q.float(), k_log.float())
    if k_scale is not None:
        sc = sc * k_scale.transpose(1, 2)
    sc = sc / math.sqrt(d)
    valid = (torch.arange(k_log.shape[1], device=q.device)[None, None, :]
             <= pos.long()[:, None, None])
    return sc.masked_fill(~valid, float("-inf"))


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, page_table: torch.Tensor,
                                 pos: torch.Tensor) -> torch.Tensor:
    """B7's plain PyTorch version (the CPU path, and the kernel's oracle
    on the card): gather the pages, mask positions past pos, softmax."""
    _check(q, (k_pool, v_pool), (), page_table, pos)
    h = q.shape[1]
    sc = _masked_scores(q, _gather(k_pool, page_table, h), pos)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p,
                        _gather(v_pool, page_table, h).float())


def paged_decode_attention_int8_plain(q, kq_pool, ks_pool, vq_pool, vs_pool,
                                      page_table, pos) -> torch.Tensor:
    """B8's plain PyTorch version: as B7's over int8 pools, with the
    per-(position, head) scales factored out of both contractions."""
    _check(q, (kq_pool, vq_pool), (ks_pool, vs_pool), page_table, pos)
    h = q.shape[1]
    sc = _masked_scores(q, _gather(kq_pool, page_table, h), pos,
                        _gather(ks_pool, page_table, h))
    p = torch.softmax(sc, dim=-1) * _gather(vs_pool, page_table, h
                                            ).transpose(1, 2)
    return torch.einsum("bhk,bkhd->bhd", p,
                        _gather(vq_pool, page_table, h).float())


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.library("paged_attention")
    fn = lib.mmk_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn8 = lib.mmk_paged_attention_int8
        fn8.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                        + [ctypes.c_longlong] * 2
                        + [ctypes.c_float, ctypes.c_void_p])
        fn8.restype = ctypes.c_int
    return lib


def _check_kernel_input(name, q, pools, scales, page_table, pos,
                        pool_dtypes) -> None:
    """What the kernels read: q bf16 or f32 with a unit-stride head dim;
    contiguous, 16-byte-aligned pools of `pool_dtypes`; contiguous f32
    scales; contiguous int32 table and positions."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: expected a bfloat16 or float32 q, got "
                        f"{q.dtype}")
    if pools[0].dtype not in pool_dtypes or pools[1].dtype != pools[0].dtype:
        raise TypeError(f"{name}: expected pools of {pool_dtypes}, got "
                        f"{pools[0].dtype}, {pools[1].dtype}")
    d = q.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM}")
    if q.dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"{name}: bf16 head dim {d} is not a multiple of 8")
    if pools[0].dtype == torch.int8 and d % 4:
        raise ValueError(f"{name}: int8 pools need a head dim that is a "
                         f"multiple of 4, got {d}")
    if q.stride(2) != 1:
        raise ValueError(f"{name}: q must be contiguous in its head dim, "
                         f"got strides {q.stride()}")
    for p in pools:
        if not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError(f"{name}: the pools must be contiguous with a "
                             f"16-byte-aligned base")
    for s in scales:
        if s.dtype != torch.float32 or not s.is_contiguous():
            raise TypeError(f"{name}: the scales must be contiguous float32")
    for t, what in ((page_table, "page_table"), (pos, "pos")):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name}: {what} must be contiguous int32, got "
                            f"{t.dtype}")


def _launch(fn, q, pointers, page_table, pos, kind: int) -> torch.Tensor:
    b, h, d = q.shape
    np_, page, hkv, _ = pointers[0].shape
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), *(p.data_ptr() for p in pointers),
                 page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), kind,
                 b, h, hkv, d, page, page_table.shape[1], q.stride(0),
                 q.stride(1), 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{err}")
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """B7: q [B, H, D] over K/V pools [NP, page, Hkv, D] -> [B, H, D] f32;
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    The kernel takes q and pools of one type, bf16 or f32, and raises on
    anything else; it never falls back."""
    global LAUNCHES
    _check(q, (k_pool, v_pool), (), page_table, pos)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    _check_kernel_input("paged_decode_attention", q, (k_pool, v_pool), (),
                        page_table, pos, (q.dtype,))
    out = _launch(_kernel_lib().mmk_paged_attention, q, (k_pool, v_pool),
                  page_table, pos, int(q.dtype == torch.bfloat16))
    LAUNCHES += 1
    return out


def paged_decode_attention_int8(q: torch.Tensor, kq_pool: torch.Tensor,
                                ks_pool: torch.Tensor, vq_pool: torch.Tensor,
                                vs_pool: torch.Tensor, page_table: torch.Tensor,
                                pos: torch.Tensor) -> torch.Tensor:
    """B8: as `paged_decode_attention` over int8 pools with f32
    per-(position, head) scales [NP, page, Hkv] (`ops.quant.quantize_kv_row`
    rows); q bf16 or f32."""
    global LAUNCHES_INT8
    _check(q, (kq_pool, vq_pool), (ks_pool, vs_pool), page_table, pos)
    if q.device.type == "cpu":
        return paged_decode_attention_int8_plain(q, kq_pool, ks_pool, vq_pool,
                                                 vs_pool, page_table, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_int8: unsupported device "
                         f"{q.device}")
    _check_kernel_input("paged_decode_attention_int8", q, (kq_pool, vq_pool),
                        (ks_pool, vs_pool), page_table, pos, (torch.int8,))
    out = _launch(_kernel_lib().mmk_paged_attention_int8, q,
                  (kq_pool, ks_pool, vq_pool, vs_pool), page_table, pos,
                  int(q.dtype == torch.bfloat16))
    LAUNCHES_INT8 += 1
    return out
