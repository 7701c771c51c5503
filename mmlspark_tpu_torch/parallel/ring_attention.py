"""Dense attention, the reference the attention kernel is held against.

Counterpart of `full_attention` in the JAX package's
`parallel/ring_attention.py`.  Ring and Ulysses attention (the
sequence-parallel variants) come with the distributed slice.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["full_attention", "attention_with_lse"]


def attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`full_attention` and the per-row logsumexp of its scaled scores,
    [B*H, Sq] f32 (the residual the flash backward reads)."""
    d = q.shape[-1]
    # the matmuls run at the input dtype with f32 accumulation: a product
    # of two bf16 values is exact in f32, so widening the inputs first is
    # that product (up to the order of the sums)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    b, h, sq = s.shape[:3]
    return out, torch.logsumexp(s, dim=-1).reshape(b * h, sq)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """Reference dense attention.  q, k, v: (B, S, H, D) -> (B, S, H, D) f32.

    Both matmuls run at the input dtype with f32 accumulation, the
    softmax statistics are f32, and the probabilities are cast to v's
    dtype before the PV product, as in the JAX package.  The causal mask
    is `tril`: query i sees keys <= i."""
    return attention_with_lse(q, k, v, causal)[0]
