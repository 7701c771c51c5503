"""TopKExperts: a dropless top-k mixture of SwiGLU experts that holds a
contiguous block of the experts and routes over all of them — the expert
layer of expert parallelism, run on one card without its exchange.

Routing (the `lfm2_moe` modelling code published with LFM2-8B-A1B):
`s = sigmoid(router(x))` over all `num_experts` experts, in f32 (the
router is `transformer.F32Linear`); the top-k experts by `s +
expert_bias` (the bias, an f32 buffer the optimizer does not train,
only selects); each selected expert's weight `s_e / (sum of the selected
s + 1e-6)` (the published `norm_topk_prob`, at `routed_scaling_factor`
1.0).  The output is the sum over a token's selected experts of `weight_e *
w2_e(silu(w1_e x) * w3_e x)`.

The layer holds experts `expert_offset .. expert_offset + experts_held -
1` (`w1`, `w3` [held, ffn, dim] and `w2` [held, dim, ffn], Linear's
[out, in] layout, one slab an expert).  Of a token's k (token, slot)
pairs it computes those whose expert it holds; the others contribute
nothing here (on a deployment the chips that hold them add their parts).
No pair is dropped: the held pairs are sorted by expert and each expert
gets a group of whatever size its tokens make.  The group sizes come to
the host once a layer (one read of a [held + 1] count vector), which
sizes the buffers; on the card the groups run as grouped matrix products
(`torch._grouped_mm`, bf16, each group padded with zero rows to a
multiple of `GROUP_ALIGN`), elsewhere as a loop over the experts with
the same arithmetic.  A token's parts are summed in f32 in slot order,
so the result does not depend on the order in which pairs finish.

Each layer's routing is counted from the sizes it reads anyway:
`models.moe.held_pairs` (pairs computed here), `models.moe.absent_pairs`
(pairs routed to experts held elsewhere) and the gauge
`models.moe.max_expert_pairs`, the largest group of any held expert in
any layer since the gauge was last set to 0.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import telemetry as core_telemetry
from ..core.telemetry.device import device_annotation
from .transformer import F32Linear

__all__ = ["TopKExperts", "Router", "select_experts", "GROUP_ALIGN"]

GROUP_ALIGN = 16  # rows: each group's start stays 16-byte aligned in bf16


class Router(F32Linear):
    """The f32 router (no bias) and its f32 `expert_bias` buffer, which
    selects experts and is not trained; both stay f32 under a module
    cast and in the trainer's bf16 working copy."""

    def __init__(self, dim: int, num_experts: int):
        super().__init__(dim, num_experts, bias=False)
        self.register_buffer("expert_bias", torch.zeros(num_experts))


def select_experts(scores: torch.Tensor, expert_bias: torch.Tensor,
                   top_k: int) -> torch.Tensor:
    """The top-k experts [T, k] of each token by `scores + expert_bias`."""
    return torch.topk(scores + expert_bias, top_k, dim=-1).indices


class TopKExperts(nn.Module):
    """The expert layer of one chip of an expert-parallel deployment (see
    the module docstring)."""

    def __init__(self, dim: int, ffn_dim: int, num_experts: int, top_k: int,
                 experts_held: int = None, expert_offset: int = 0):
        super().__init__()
        held = num_experts if experts_held is None else int(experts_held)
        if not (0 < held and 0 <= expert_offset
                and expert_offset + held <= num_experts):
            last = expert_offset + held - 1
            raise ValueError(f"experts {expert_offset}..{last} are not "
                             f"among {num_experts}")
        if not 0 < top_k <= num_experts:
            raise ValueError(f"top_k={top_k} of {num_experts} experts")
        self.num_experts = int(num_experts)
        self.top_k = int(top_k)
        self.experts_held = held
        self.expert_offset = int(expert_offset)
        self.w1 = nn.Parameter(torch.empty(held, ffn_dim, dim))
        self.w3 = nn.Parameter(torch.empty(held, ffn_dim, dim))
        self.w2 = nn.Parameter(torch.empty(held, dim, ffn_dim))
        self.gate = Router(dim, num_experts)

    def route(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """t [T, dim] -> (experts [T, k] global ids, weights [T, k] f32)."""
        scores = torch.sigmoid(self.gate(t))
        expert = select_experts(scores, self.gate.expert_bias, self.top_k)
        weight = scores.gather(1, expert)
        return expert, weight / (weight.sum(-1, keepdim=True) + 1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        t = x.reshape(-1, shape[-1])
        with device_annotation("lfm2.moe.route"):
            expert, weight = self.route(t)
        with device_annotation("lfm2.moe.experts"):
            out = self._experts(t, expert, weight)
        return out.view(shape)

    def _experts(self, t: torch.Tensor, expert: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
        n_tok, k = expert.shape
        held = self.experts_held
        local = (expert - self.expert_offset).reshape(-1)
        # absent pairs sort last, under the key `held`
        key = torch.where((local >= 0) & (local < held), local,
                          torch.full_like(local, held))
        pairs = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=held + 1).tolist()
        sizes = counts[:held]
        n_held = sum(sizes)
        _count(n_held, n_tok * k - n_held, max(sizes))
        # with no held pair the products run on no rows: the held experts
        # still get their (zero) gradient, which Adam's moments step
        pairs = pairs[:n_held]
        rows = t.index_select(0, pairs // k)
        y = self._grouped_swiglu(rows, sizes)
        y = y * weight.reshape(-1).index_select(0, pairs)[:, None].to(y.dtype)
        # each pair's part in its (token, slot) place, summed over slots
        parts = t.new_zeros(n_tok * k, t.shape[1]).index_copy(0, pairs, y)
        return parts.view(n_tok, k, -1).sum(1, dtype=torch.float32).to(t.dtype)

    def _grouped_swiglu(self, rows: torch.Tensor, sizes: List[int]
                        ) -> torch.Tensor:
        """rows [P, dim] in groups of `sizes` rows, one a held expert ->
        [P, dim]: w2(silu(w1 x) * w3 x) with each group's expert."""
        w1, w3, w2 = (w.to(rows.dtype) for w in (self.w1, self.w3, self.w2))
        if rows.device.type == "cuda" and rows.dtype == torch.bfloat16 \
                and hasattr(torch, "_grouped_mm") and len(rows):
            return _grouped_swiglu_card(rows, sizes, w1, w3, w2)
        out, start = [], 0
        for e, n in enumerate(sizes):
            x = rows[start:start + n]
            start += n
            out.append(F.linear(F.silu(F.linear(x, w1[e])) * F.linear(x, w3[e]),
                                w2[e]))
        return torch.cat(out) if out else rows.new_zeros(0, w2.shape[1])


def _grouped_swiglu_card(rows: torch.Tensor, sizes: List[int], w1, w3, w2
                         ) -> torch.Tensor:
    """The card's path: rows scattered into groups padded with zero rows
    to multiples of GROUP_ALIGN (a padded row computes 0 and receives no
    gradient), three grouped products, the real rows gathered back."""
    padded = [-(-n // GROUP_ALIGN) * GROUP_ALIGN for n in sizes]
    ends, starts, at = [], [], 0
    for n, p in zip(sizes, padded):
        starts.append(at)
        at += p
        ends.append(at)
    dev = rows.device
    begin, run = [], 0
    for n in sizes:
        begin.append(run)
        run += n
    # row i of group e goes to starts[e] + (i - begin[e])
    shift = torch.tensor([s - b for s, b in zip(starts, begin)],
                         dtype=torch.long).to(dev, non_blocking=True)
    dest = torch.arange(len(rows), device=dev) + torch.repeat_interleave(
        shift, torch.tensor(sizes).to(dev, non_blocking=True),
        output_size=len(rows))
    offs = torch.tensor(ends, dtype=torch.int32).to(dev, non_blocking=True)
    x = rows.new_zeros(at, rows.shape[1]).index_copy(0, dest, rows)
    h = F.silu(torch._grouped_mm(x, w1.transpose(-2, -1), offs=offs)) \
        * torch._grouped_mm(x, w3.transpose(-2, -1), offs=offs)
    y = torch._grouped_mm(h, w2.transpose(-2, -1), offs=offs)
    return y.index_select(0, dest)


def _count(held: int, absent: int, largest: int) -> None:
    core_telemetry.incr("models.moe.held_pairs", held)
    core_telemetry.incr("models.moe.absent_pairs", absent)
    g = core_telemetry.gauge("models.moe.max_expert_pairs")
    if largest > g.value:
        g.set(largest)
