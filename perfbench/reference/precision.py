"""Precision switches of the reference and its lower-precision control.

`ieee_fp32` turns TF32 off for matrix products and cuDNN convolutions
(float32 is then computed as float32), through PyTorch's newer flags only:
reading the older `allow_tf32` flags raises once both kinds were set.
`fp8_e4m3` rounds a tensor to float8 e4m3 under one per-tensor scale (its
largest magnitude mapped to 448), the precision below bfloat16 that a
lower-precision path would take.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["ieee_fp32", "fp8_e4m3"]


@contextlib.contextmanager
def ieee_fp32():
    matmul = torch.backends.cuda.matmul
    conv = torch.backends.cudnn.conv
    before = (matmul.fp32_precision, conv.fp32_precision)
    matmul.fp32_precision = "ieee"
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision, conv.fp32_precision = before


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
