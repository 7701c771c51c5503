"""Top-k along the last axis with `jax.lax.top_k`'s order.

`jax.lax.top_k` returns the k largest values in descending order and,
among equal values, the lower index first.  `torch.topk` on CUDA does not
promise which of several equal values it returns, nor their order, and
ties are common where the port needs the rule: masked scores (-inf),
zero scores, constructed duplicates.  `topk_lower_index` takes
`torch.topk`'s k-th value as a threshold, and where more than k entries
of a row reach it, keeps the lowest-indexed ones among those equal to it;
then it orders the k by (value descending, index ascending).  NaN scores
are not supported.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["topk_lower_index"]


def topk_lower_index(scores: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [..., k], indices [..., k] int64) of the k largest entries
    of each row, ties to the lower index, as `jax.lax.top_k`."""
    if not 0 <= k <= scores.shape[-1]:
        raise ValueError(f"topk_lower_index: k={k} for rows of "
                         f"{scores.shape[-1]}")
    lead = scores.shape[:-1]
    flat = scores.reshape(-1, scores.shape[-1])
    vals, idx = torch.topk(flat, k, dim=-1)
    if k:
        kth = vals[:, -1:]
        # rows where more than k entries reach the k-th value: the set
        # torch.topk chose among the equal ones may not be the lowest
        tied = torch.nonzero((flat >= kth).sum(dim=-1) > k).flatten()
        if tied.numel():
            sub = flat[tied]
            t = kth[tied]
            above = sub > t
            equal = sub == t
            room = k - above.sum(dim=-1, keepdim=True)
            keep = above | (equal & (torch.cumsum(equal, dim=-1) <= room))
            idx[tied] = torch.nonzero(keep)[:, 1].reshape(-1, k)
        idx = torch.sort(idx, dim=-1).values
        vals = torch.gather(flat, -1, idx)
        order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
        idx = torch.gather(idx, -1, order)
        vals = torch.gather(vals, -1, order)
    return vals.reshape(*lead, k), idx.reshape(*lead, k)
