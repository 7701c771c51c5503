"""Compressed-wire codec: RLE-encoded pixels decoded on the card.

Counterpart of the JAX package's `ops/wire_codec.py`.  The host side
(`RLEPayload`, `rle_encode`, `decode_host`, `rle_ratio` and the wire
constants) is a copy and gives the same arrays: each chunk's raw bytes
as (value, run) pairs with runs capped at RUN_CAP, shipped as `values`
(uint8[R]) and the cumulative `ends` table (int32[R]), both padded to a
power-of-two run count R >= 2*BLOCK, with a terminal pad run ending at
the BLOCK-padded length `n_pad`.  `first_run` (the TPU kernel's
scalar-prefetch table) is still built, so payloads equal the JAX
package's, but the wire and the decode do not use it.

The device side replaces the Pallas kernel
`mmlspark_tpu/ops/wire_codec.py::_pallas_decode` (`pallas_call` at L231)
with `csrc/rle_decode.cu`, written by hand for Hopper: output byte p
takes `values[upper_bound(ends, p)]`, the value of the first run whose
cumulative end exceeds p (its source explains the design).
`decode_bytes` takes the kernel for a CUDA tensor and `decode_bytes_plain`
(values repeated by the run lengths) for a CPU tensor; `LAUNCHES` counts
the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

__all__ = ["RLEPayload", "rle_encode", "rle_ratio", "decode_host",
           "decode_bytes", "decode_bytes_plain", "MIN_WIRE_RATIO",
           "RUN_CAP", "BLOCK", "LAUNCHES"]

RUN_CAP = 255        # max run length per entry (worst case 5 bytes/run wire)
BLOCK = 128          # the decoded length is padded to a multiple of this
MIN_WIRE_RATIO = 1.5  # the JAX feed takes the compressed path only above this

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


class RLEPayload:
    """One host chunk, RLE-encoded for the wire.

    `values`/`ends` are the padded wire arrays (uint8[R], int32[R], R a
    power of two >= 2*BLOCK); `first_run` is the JAX package's
    scalar-prefetch table (kept for parity, unused here); `shape`/`dtype`
    restore the chunk; `n_pad` is the padded decoded byte length (a
    multiple of BLOCK)."""

    __slots__ = ("values", "ends", "first_run", "shape", "dtype",
                 "nbytes_raw", "n_pad")

    def __init__(self, values: np.ndarray, ends: np.ndarray,
                 first_run: np.ndarray, shape: Tuple[int, ...],
                 dtype: np.dtype, nbytes_raw: int, n_pad: int):
        self.values = values
        self.ends = ends
        self.first_run = first_run
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.nbytes_raw = int(nbytes_raw)
        self.n_pad = int(n_pad)

    @property
    def wire_nbytes(self) -> int:
        return int(self.values.nbytes + self.ends.nbytes)


def _pow2_at_least(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def rle_encode(arr: np.ndarray) -> RLEPayload:
    """Byte-level RLE of `arr`'s raw buffer, runs capped at RUN_CAP.

    Vectorized: change points via one diff over the byte view, then the
    cap splits long runs arithmetically — no Python-per-byte loop."""
    arr = np.ascontiguousarray(arr)
    raw = arr.reshape(-1).view(np.uint8)
    n = raw.size
    if n == 0:
        raise ValueError("cannot RLE-encode an empty array")
    # run boundaries: index i starts a run iff raw[i] != raw[i-1]
    starts = np.flatnonzero(np.concatenate(
        ([True], raw[1:] != raw[:-1])))
    lengths = np.diff(np.concatenate((starts, [n]))).astype(np.int64)
    vals = raw[starts]
    # split runs longer than RUN_CAP into ceil(len/cap) capped pieces
    pieces = -(-lengths // RUN_CAP)
    values = np.repeat(vals, pieces)
    counts = np.full(values.size, RUN_CAP, np.int64)
    # last piece of each run carries the remainder
    last = np.cumsum(pieces) - 1
    rem = lengths - (pieces - 1) * RUN_CAP
    counts[last] = rem
    ends = np.cumsum(counts)
    # pad the decoded length to a BLOCK multiple with one final pad run,
    # then pad the run count to a power of two with zero-length runs
    n_pad = -(-n // BLOCK) * BLOCK
    # always append a terminal pad run ending at n_pad: padded output
    # positions must resolve to SOME run
    ends = np.concatenate((ends, np.array([n_pad], np.int64)))
    values = np.concatenate((values, np.array([0], np.uint8)))
    r_pad = _pow2_at_least(ends.size, 2 * BLOCK)
    ends_p = np.full(r_pad, n_pad, np.int32)
    ends_p[:ends.size] = ends
    vals_p = np.zeros(r_pad, np.uint8)
    vals_p[:values.size] = values
    nb = n_pad // BLOCK
    first_run = np.searchsorted(
        ends_p, np.arange(nb, dtype=np.int64) * BLOCK, side="right"
    ).astype(np.int32)
    return RLEPayload(vals_p, ends_p, first_run, arr.shape, arr.dtype,
                      n, n_pad)


def decode_host(payload: RLEPayload) -> np.ndarray:
    """Host-side decode: the raw chunk back from its payload."""
    counts = np.diff(payload.ends.astype(np.int64), prepend=0)
    raw = np.repeat(payload.values, counts)
    return (raw[:payload.nbytes_raw].view(payload.dtype)
            .reshape(payload.shape))


def rle_ratio(payload: RLEPayload) -> float:
    """Raw bytes per wire byte — the compression the wire would see."""
    return payload.nbytes_raw / max(1, payload.wire_nbytes)


def _check(values: torch.Tensor, ends: torch.Tensor, n_pad: int) -> None:
    if values.dtype != torch.uint8 or ends.dtype != torch.int32:
        raise TypeError(f"decode_bytes: expected uint8 values and int32 ends, "
                        f"got {values.dtype} and {ends.dtype}")
    if values.dim() != 1 or ends.shape != values.shape or values.numel() < 1:
        raise ValueError(f"decode_bytes: values {tuple(values.shape)} and ends "
                         f"{tuple(ends.shape)} must be one non-empty run table")
    if values.device != ends.device:
        raise ValueError("decode_bytes: values and ends on different devices")
    if n_pad < 0 or n_pad % BLOCK:
        raise ValueError(f"decode_bytes: n_pad {n_pad} is not a multiple of {BLOCK}")


def decode_bytes_plain(values: torch.Tensor, ends: torch.Tensor,
                       n_pad: int) -> torch.Tensor:
    """The plain PyTorch version of the decode: each value repeated by its
    run's length, the difference of consecutive ends (the CPU path, and
    the kernel's oracle on the card)."""
    _check(values, ends, n_pad)
    counts = torch.diff(ends.to(torch.int64),
                        prepend=torch.zeros(1, dtype=torch.int64,
                                            device=ends.device))
    return torch.repeat_interleave(values, counts, output_size=int(n_pad))


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.library("rle_decode")
    fn = lib.mmk_rle_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def decode_bytes(values: torch.Tensor, ends: torch.Tensor,
                 n_pad: int) -> torch.Tensor:
    """values/ends already on the device -> decoded uint8[n_pad] there:
    the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    global LAUNCHES
    _check(values, ends, n_pad)
    if values.device.type == "cpu":
        return decode_bytes_plain(values, ends, n_pad)
    if values.device.type != "cuda":
        raise ValueError(f"decode_bytes: unsupported device {values.device}")
    if not (values.is_contiguous() and ends.is_contiguous()):
        raise ValueError("decode_bytes: values and ends must be contiguous")
    if n_pad >= 2 ** 31:
        raise ValueError("decode_bytes: n_pad must fit the int32 ends table")
    if ends.data_ptr() % 16 or values.data_ptr() % 4:
        raise ValueError("decode_bytes: the kernel reads ends 16 bytes and "
                         "values 4 bytes at a time: ends must be 16-byte and "
                         "values 4-byte aligned")
    out = torch.empty(int(n_pad), dtype=torch.uint8, device=values.device)
    lib = _kernel_lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmk_rle_decode(values.data_ptr(), ends.data_ptr(),
                                 int(values.numel()), out.data_ptr(),
                                 int(n_pad), stream)
    if err != 0:
        raise RuntimeError(f"rle_decode kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
