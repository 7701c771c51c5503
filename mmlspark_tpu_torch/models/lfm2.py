"""Lfm2MoeLM: Liquid AI's LFM2 hybrid mixture-of-experts language model
(`model_type` "lfm2_moe", LFM2-8B-A1B), on the port's LM training path.

The layer equations of the `lfm2_moe` modelling code published with the
checkpoint, with its parameter names:

* every layer: `h = x + op(operator_norm(x))`, `out = h + feed_forward(
  ffn_norm(h))`, RMSNorm (`F.rms_norm`, weight 1 at init) at `norm_eps`;
* `op` of a "conv" layer, the short convolution: `[B | C | x~] =
  in_proj(x)` (dim -> 3 dim, no bias, split in that order), `u = B * x~`,
  `v` the depthwise causal convolution of `u` over `conv_L_cache`
  positions (`v_t = sum_j w_j u_{t-L+1+j}`, zeros before position 0),
  `out_proj(C * v)`;
* `op` of a "full_attention" layer: q (H heads) and k, v (Hkv heads) of
  head_dim = dim / H, no biases; an RMSNorm over head_dim on each q and k
  head (`q_layernorm`, `k_layernorm`); RoPE at `rope_theta`, first half
  against second half (`transformer._rope`); causal softmax attention at
  1/sqrt(head_dim), each K/V head serving H / Hkv adjacent query heads
  (`transformer._gqa_expand`, `transformer.default_attn(True)`: the flash
  kernels B4/B5/B6 for CUDA tensors, dense attention on the CPU); then
  `out_proj`;
* `feed_forward` of the first `num_dense_layers` layers: SwiGLU
  `w2(silu(w1 x) * w3 x)` of width `intermediate_size`; of the others,
  `moe.TopKExperts` (sigmoid router over `num_experts`, top
  `num_experts_per_tok` by score plus the untrained expert bias, SwiGLU
  experts of width `moe_intermediate_size`), holding experts
  `expert_offset .. expert_offset + experts_held - 1`;
* after the last layer, `embedding_norm` (an RMSNorm), then `lm_head`,
  tied to `embed_tokens` (the LFM2 family's `tie_embedding`).

The forward follows `TransformerLM.forward`: tokens [B, S] -> (logits
[B, S, V] f32, taps `logits`, `pool`, `hidden`, `embed`), so
`training._forward`, `lm_loss` and `make_lm_train_epoch` take it as they
take the TransformerLM.  The model has no load-balance loss (the expert
bias balances).  Decoding is not supported: it needs each conv layer's
rolling `conv_L_cache`-token state beside the attention layers' KV
cache, and every decode entry raises `NotImplementedError`.

Under `core.telemetry.device.enable_device_annotations()` a profiler
capture shows each layer's parts as `lfm2.conv`, `lfm2.attn`,
`lfm2.moe.route`, `lfm2.moe.experts` and `lfm2.ffn`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.telemetry.device import device_annotation
from .moe import TopKExperts
from .transformer import _gqa_expand, _rope, _torch_dtype, default_attn

__all__ = ["Lfm2MoeLM", "lfm2_moe", "short_conv", "qk_norm"]

_DECODE = ("Lfm2MoeLM does not decode: its conv layers' rolling state "
           "beside the attention layers' KV cache is not implemented")


def short_conv(u: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The depthwise causal convolution of u [B, S, C] with `weight`
    [C, 1, L]: v_t = sum_j weight[:, 0, j] * u_{t-L+1+j}, zeros before
    position 0."""
    L = weight.shape[-1]
    v = F.conv1d(F.pad(u.transpose(1, 2), (L - 1, 0)), weight,
                 groups=u.shape[-1])
    return v.transpose(1, 2)


def qk_norm(attn: "_Attention", q: torch.Tensor, k: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-head RMSNorms of q [B, S, H, D] and k [B, S, Hkv, D]."""
    return attn.q_layernorm(q), attn.k_layernorm(k)


class _ShortConv(nn.Module):
    def __init__(self, dim: int, l_cache: int):
        super().__init__()
        self.in_proj = nn.Linear(dim, 3 * dim, bias=False)
        self.conv = nn.Conv1d(dim, dim, l_cache, groups=dim, bias=False)
        self.out_proj = nn.Linear(dim, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with device_annotation("lfm2.conv"):
            b, c, xt = self.in_proj(x).chunk(3, dim=-1)
            return self.out_proj(c * short_conv(b * xt, self.conv.weight))


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, kv_heads: int, eps: float,
                 rope_theta: float, attn_fn: Callable):
        super().__init__()
        if dim % heads or heads % kv_heads:
            raise ValueError(f"{heads} heads over {kv_heads} K/V heads do "
                             f"not divide a width of {dim}")
        self.heads, self.kv_heads = heads, kv_heads
        self.head_dim = dim // heads
        self.rope_theta = float(rope_theta)
        self.attn_fn = attn_fn
        d = self.head_dim
        self.q_proj = nn.Linear(dim, heads * d, bias=False)
        self.k_proj = nn.Linear(dim, kv_heads * d, bias=False)
        self.v_proj = nn.Linear(dim, kv_heads * d, bias=False)
        self.out_proj = nn.Linear(heads * d, dim, bias=False)
        self.q_layernorm = nn.RMSNorm(d, eps=eps)
        self.k_layernorm = nn.RMSNorm(d, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        h, hkv, d = self.heads, self.kv_heads, self.head_dim
        with device_annotation("lfm2.attn"):
            q = self.q_proj(x).view(b, s, h, d)
            k = self.k_proj(x).view(b, s, hkv, d)
            v = self.v_proj(x).view(b, s, hkv, d)
            q, k = qk_norm(self, q, k)
            pos = torch.arange(s, device=x.device)
            q = _rope(q, pos, self.rope_theta)
            k = _rope(k, pos, self.rope_theta)
            a = self.attn_fn(q, _gqa_expand(k, h), _gqa_expand(v, h))
            return self.out_proj(a.to(x.dtype).reshape(b, s, h * d))


class _SwiGLU(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.w1 = nn.Linear(dim, ffn_dim, bias=False)
        self.w3 = nn.Linear(dim, ffn_dim, bias=False)
        self.w2 = nn.Linear(ffn_dim, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with device_annotation("lfm2.ffn"):
            return self.w2(F.silu(self.w1(x)) * self.w3(x))


class _Layer(nn.Module):
    def __init__(self, op: nn.Module, feed_forward: nn.Module, dim: int,
                 eps: float):
        super().__init__()
        self.operator_norm = nn.RMSNorm(dim, eps=eps)
        self.op_name = "conv" if isinstance(op, _ShortConv) else "self_attn"
        self.add_module(self.op_name, op)
        self.ffn_norm = nn.RMSNorm(dim, eps=eps)
        self.feed_forward = feed_forward

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x + getattr(self, self.op_name)(self.operator_norm(x))
        return h + self.feed_forward(self.ffn_norm(h))


class Lfm2MoeLM(nn.Module):
    """See the module docstring.  The keyword arguments are the published
    config's keys; `experts_held` / `expert_offset` say which experts of
    every expert layer this chip holds (all of them by default).  The
    published LFM2-MoE values of `conv_bias` (false), `use_expert_bias`,
    `norm_topk_prob`, `routed_scaling_factor` (1.0) and `tie_embedding`
    are built in."""

    layer_names = ["logits", "pool", "hidden", "embed"]
    input_dtype = "int32"  # token ids

    def __init__(self, vocab_size: int = 65536, hidden_size: int = 2048,
                 layer_types: Sequence[str] = ("conv", "full_attention"),
                 num_attention_heads: int = 32, num_key_value_heads: int = 8,
                 intermediate_size: int = 7168,
                 moe_intermediate_size: int = 1792,
                 num_dense_layers: int = 1, num_experts: int = 32,
                 num_experts_per_tok: int = 4,
                 experts_held: Optional[int] = None, expert_offset: int = 0,
                 norm_eps: float = 1e-5, rope_theta: float = 1e6,
                 conv_L_cache: int = 3):
        super().__init__()
        kinds = {"conv", "full_attention"}
        if not set(layer_types) <= kinds:
            raise ValueError(f"layer_types must be among {sorted(kinds)}, "
                             f"got {sorted(set(layer_types) - kinds)}")
        self.vocab_size = vocab_size
        self.layer_types = list(layer_types)
        attn = default_attn(True)
        d = hidden_size
        self.embed_tokens = nn.Embedding(vocab_size, d)
        layers = []
        for i, kind in enumerate(self.layer_types):
            op = (_ShortConv(d, conv_L_cache) if kind == "conv" else
                  _Attention(d, num_attention_heads, num_key_value_heads,
                             norm_eps, rope_theta, attn))
            ffn = (_SwiGLU(d, intermediate_size) if i < num_dense_layers else
                   TopKExperts(d, moe_intermediate_size, num_experts,
                               num_experts_per_tok, experts_held,
                               expert_offset))
            layers.append(_Layer(op, ffn, d, norm_eps))
        self.layers = nn.ModuleList(layers)
        self.embedding_norm = nn.RMSNorm(d, eps=norm_eps)
        self.lm_head = nn.Linear(d, vocab_size, bias=False)
        self._tie()

    def _tie(self) -> None:
        self.lm_head.weight = self.embed_tokens.weight

    def _apply(self, fn, recurse=True):
        # a conversion that makes new parameters (`to_empty`, a device
        # move) makes one for each module that holds the tied weight
        out = super()._apply(fn, recurse)
        self._tie()
        return out

    def forward(self, tokens: torch.Tensor, train: bool = False,
                kvcache: Optional[List] = None, aux: Optional[List] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens [B, S] -> (logits [B, S, V] f32, taps)."""
        if kvcache is not None:
            raise NotImplementedError(_DECODE)
        taps: Dict[str, torch.Tensor] = {}
        x = self.embed_tokens(tokens)
        taps["embed"] = x
        for layer in self.layers:
            x = layer(x)
        x = self.embedding_norm(x)
        taps["hidden"] = x
        taps["pool"] = x.mean(dim=1).float()
        logits = self.lm_head(x).float()
        taps["logits"] = logits
        return logits, taps

    def decode_step(self, *args, **kwargs):
        raise NotImplementedError(_DECODE)


def lfm2_moe(dtype=None, num_classes=None, **kwargs) -> Lfm2MoeLM:
    """Builder (zoo registry): `Lfm2MoeLM(**kwargs)`, cast to `dtype` when
    given; `num_classes` is accepted and ignored, as `transformer_lm`
    does."""
    m = Lfm2MoeLM(**kwargs)
    return m if dtype is None else m.to(_torch_dtype(dtype))
