"""Int8 KV-cache rows.

Counterpart of `quantize_kv_row` in the JAX package's `ops/quant.py`,
with its rounding kept so that the two give the same bits: the scale is
max(|x|, 1e-8) / 127 per (position, head), the row is DIVIDED by it (not
multiplied by its reciprocal), and `torch.round` rounds half to even as
`jnp.round` does.  The int8 matmul layers (`QuantDense`, `prequantize`)
are not ported yet (ROADMAP A14).
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["quantize_kv_row"]

_EPS = 1e-8


def quantize_kv_row(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., H, D] K/V rows -> (int8 rows, f32 per-row-per-head scales
    [..., H]): symmetric per-(position, head) scaling."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1), min=_EPS) / 127.0
    q = torch.round(xf / s[..., None]).to(torch.int8)
    return q, s
