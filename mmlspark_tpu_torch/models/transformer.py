"""TransformerLM: a decoder-only language model, and the pre-LN block it
shares with the Vision Transformer.

Counterpart of the JAX package's `models/transformer.py` (flax), with the
same parameter names, taps and numerics:

* LayerNorm epsilon 1e-6 (flax's default; torch's is 1e-5);
* GELU is the tanh approximation (flax's `nn.gelu` default);
* `qkv`, `q`, `kv`, `proj` and the LM `head` have no bias; `mlp_in` and
  `mlp_out` do;
* the fused qkv output reshapes to (B, S, 3H, D) and splits into three
  equal parts along the head axis; the GQA `kv` output to (B, S, 2Hkv, D)
  with k first;
* GQA expands K/V heads with `repeat_interleave` (`jnp.repeat`), not
  `tile`;
* RoPE rotates first half against second half, not interleaved pairs;
* attention takes q/k/v at the model dtype, returns f32 with the scale
  1/sqrt(D) and f32 softmax statistics, and is cast back to the model
  dtype before `proj`.

The compute dtype is the dtype of the module's parameters
(`module.to(dtype)`): bf16 on the card, as the JAX package runs it.

Attention: `default_attn` gives the flash-attention kernel
(`ops.attention_kernels.fused_attention`) for CUDA tensors and the plain
`full_attention` for CPU tensors.  Decode attends over the dense KV cache
with `_cache_attention`, plain PyTorch, as the JAX package leaves it to
XLA.

Not ported yet (they raise NotImplementedError naming ROADMAP A14):
int8 inference (`quant=True`), mixture-of-experts MLPs
(`moe_experts > 0`), the int8 4-tuple KV cache, and slot / paged decode
(`page_table`, per-slot `pos`).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["TransformerLM", "transformer_lm", "default_attn"]

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon
_WAITS = "ROADMAP A14"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mmlspark_tpu_torch yet ({_WAITS})")


def _cache_attention(q, k_cache, v_cache, q_pos, d):
    """s queries over a [B, L, H, D] cache, query (b, i) masked to cache
    positions <= q_pos[b, i] (q_pos [B|1, s]).  Returns (B, s, H, D) f32.
    (The JAX package's int8-cache scales wait with the int8 cache.)"""
    n = k_cache.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float())
    sc = sc / math.sqrt(d)
    valid = (torch.arange(n, device=q.device)[None, None, :]
             <= q_pos[:, :, None])                       # [B|1, s, L]
    sc = sc.masked_fill(~valid[:, None, :, :], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v_cache.dtype).float(),
                        v_cache.float())


def _rope(x: torch.Tensor, positions: torch.Tensor,
          base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding of [B, S, H, D] q/k at `positions` [S]
    (shared by the batch; per-row positions wait with slot decode): the
    first half of D rotates against the second half."""
    d2 = x.shape[-1] // 2
    inv = 1.0 / (base ** (torch.arange(d2, dtype=torch.float32,
                                       device=x.device) / d2))
    ang = (positions.to(torch.float32)[:, None] * inv)[None, :, None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _gqa_expand(kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, Hkv, D] K/V -> repeated to num_heads along the head axis
    (`jnp.repeat`: each K/V head serves num_heads // Hkv adjacent query
    heads).  A no-op for MHA."""
    reps = num_heads // kv.shape[2]
    if reps == 1:
        return kv
    return torch.repeat_interleave(kv, reps, dim=2)


def default_attn(causal: bool) -> Callable:
    """The default attention of TransformerLM and ViT: `fused_attention`,
    which runs the flash kernel for CUDA tensors and its plain version,
    dense `full_attention`, for CPU tensors."""
    from ..ops.attention_kernels import fused_attention

    return functools.partial(fused_attention, causal=causal)


class _Block(nn.Module):
    """Pre-LN transformer block; flax names ln1, qkv (or q + kv), proj,
    ln2, mlp_in, mlp_out."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int,
                 attn_fn: Optional[Callable], kv_heads: Optional[int] = None,
                 rope: bool = False):
        super().__init__()
        e, h = embed_dim, num_heads
        self.num_heads = h
        self.kv_heads = kv_heads or h
        self.head_dim = e // h
        self.attn_fn = attn_fn
        self.rope = rope
        self.ln1 = nn.LayerNorm(e, eps=LN_EPS)
        if self.kv_heads == h:
            self.qkv = nn.Linear(e, 3 * e, bias=False)
        else:
            self.q = nn.Linear(e, e, bias=False)
            self.kv = nn.Linear(e, 2 * self.kv_heads * self.head_dim,
                                bias=False)
        self.proj = nn.Linear(e, e, bias=False)
        self.ln2 = nn.LayerNorm(e, eps=LN_EPS)
        self.mlp_in = nn.Linear(e, mlp_ratio * e)
        self.mlp_out = nn.Linear(mlp_ratio * e, e)

    def forward(self, x: torch.Tensor, cache=None, pos=None, page_table=None,
                kvcache: Optional[List] = None):
        """cache=None: attention over x (the train/score/prefill path);
        `kvcache`, a list, receives this layer's (k, v) [B, S, Hkv, D] (the
        JAX package's sown 'kvcache' collection).

        cache=(k_cache, v_cache) [B, max_len, Hkv, D] with an int `pos`:
        block decode — x holds the tokens at positions pos..pos+s-1, their
        K/V are written into the cache IN PLACE at `pos` (the JAX package
        returns an updated copy; the port saves the copy), and query i
        attends over cache positions <= pos+i.  Returns (out, cache)."""
        b, s, e = x.shape
        h, hkv, d = self.num_heads, self.kv_heads, self.head_dim
        y = self.ln1(x)
        if hkv == h:
            q, k, v = self.qkv(y).view(b, s, 3 * h, d).split(h, dim=2)
        else:
            q = self.q(y).view(b, s, h, d)
            k, v = self.kv(y).view(b, s, 2 * hkv, d).split(hkv, dim=2)
        if cache is not None and (page_table is not None
                                  or torch.is_tensor(pos) and pos.dim() == 1):
            raise _not_ported("slot and paged decode")
        if self.rope:
            rp = torch.arange(s, device=x.device)
            if cache is not None:
                rp = rp + int(pos)
            q = _rope(q, rp)
            k = _rope(k, rp)
        if cache is None:
            if kvcache is not None:
                kvcache.append((k, v))
            a = self.attn_fn(q, _gqa_expand(k, h), _gqa_expand(v, h))
        else:
            if len(cache) != 2:
                raise _not_ported("the int8 KV cache")
            pos = int(pos)
            k_cache, v_cache = cache
            k_cache[:, pos:pos + s] = k.to(k_cache.dtype)
            v_cache[:, pos:pos + s] = v.to(v_cache.dtype)
            q_pos = (pos + torch.arange(s, device=x.device))[None]
            # positions past pos + s - 1 are masked for every query, so
            # only the cache up to there is read: the JAX package's result
            # over its whole static-length cache, from fewer bytes
            n = pos + s
            a = _cache_attention(q, _gqa_expand(k_cache[:, :n], h),
                                 _gqa_expand(v_cache[:, :n], h), q_pos, d)
        a = a.to(x.dtype).reshape(b, s, e)
        x = x + self.proj(a)
        y = self.mlp_in(self.ln2(x))
        out = x + self.mlp_out(F.gelu(y, approximate="tanh"))
        return out if cache is None else (out, cache)


class TransformerLM(nn.Module):
    """Decoder-only LM over int token ids [B, S]; flax names tok_embed,
    pos_embed (learned positions), block{i} (here `blocks.{i}`), ln_f,
    head."""

    layer_names = ["logits", "pool", "hidden", "embed"]
    input_dtype = "int32"  # token ids

    def __init__(self, vocab_size: int = 1024, embed_dim: int = 128,
                 num_layers: int = 2, num_heads: int = 4,
                 max_len: int = 2048, mlp_ratio: int = 4,
                 attn_fn: Optional[Callable] = None, quant: bool = False,
                 moe_experts: int = 0, moe_capacity: float = 1.25,
                 pos_emb: str = "learned",
                 num_kv_heads: Optional[int] = None):
        super().__init__()
        if quant:
            raise _not_ported("int8 inference (quant=True)")
        if moe_experts > 0:
            raise _not_ported("the mixture-of-experts MLP (moe_experts > 0)")
        if pos_emb not in ("learned", "rope"):
            raise ValueError(
                f"pos_emb must be 'learned' or 'rope', got {pos_emb!r} — "
                "anything else would silently build a position-blind model")
        if num_kv_heads is not None and (
                num_kv_heads < 1 or num_heads % num_kv_heads != 0):
            raise ValueError(f"num_kv_heads={num_kv_heads} must divide "
                             f"num_heads={num_heads}")
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_len = max_len
        self.pos_emb = pos_emb
        self.num_kv_heads = num_kv_heads
        attn = attn_fn if attn_fn is not None else default_attn(True)
        self.tok_embed = nn.Embedding(vocab_size, embed_dim)
        if pos_emb == "learned":
            self.pos_embed = nn.Embedding(max_len, embed_dim)
        self.blocks = nn.ModuleList(
            _Block(embed_dim, num_heads, mlp_ratio, attn,
                   kv_heads=num_kv_heads, rope=pos_emb == "rope")
            for _ in range(num_layers))
        self.ln_f = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = nn.Linear(embed_dim, vocab_size, bias=False)

    @property
    def kv_heads(self) -> int:
        """K/V head count: the head dimension of the KV cache."""
        return self.num_kv_heads or self.num_heads

    def _embed(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        x = self.tok_embed(tokens)
        if self.pos_emb == "learned":
            idx = torch.arange(tokens.shape[1], device=tokens.device) + pos
            x = x + self.pos_embed(idx)[None]
        return x

    def forward(self, tokens: torch.Tensor, train: bool = False,
                kvcache: Optional[List] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens [B, S] -> (logits [B, S, V] f32, taps).  With `kvcache`
        (a list) every layer appends its (k, v): generation's prefill."""
        taps: Dict[str, torch.Tensor] = {}
        x = self._embed(tokens, 0)
        taps["embed"] = x
        for block in self.blocks:
            x = block(x, kvcache=kvcache)
        x = self.ln_f(x)
        taps["hidden"] = x
        taps["pool"] = x.mean(dim=1).float()
        logits = self.head(x).float()
        taps["logits"] = logits
        return logits, taps

    def decode_step(self, token: torch.Tensor, cache: Sequence, pos,
                    page_table=None) -> Tuple[torch.Tensor, tuple]:
        """Block decode: token [B, s] at positions pos..pos+s-1 attends over
        the per-layer KV cache, written in place at `pos`.  Returns
        (logits [B, s, V] f32, cache)."""
        if page_table is not None or (torch.is_tensor(pos) and pos.dim() == 1):
            raise _not_ported("slot and paged decode")
        pos = int(pos)
        x = self._embed(token, pos)
        new_cache = []
        for block, layer_cache in zip(self.blocks, cache):
            x, layer_cache = block(x, cache=layer_cache, pos=pos)
            new_cache.append(layer_cache)
        logits = self.head(self.ln_f(x)).float()
        return logits, tuple(new_cache)


def transformer_lm(vocab_size=1024, embed_dim=128, num_layers=2, num_heads=4,
                   max_len=2048, dtype=None, attn_fn=None, quant=False,
                   moe_experts=0, moe_capacity=1.25, pos_emb="learned",
                   num_kv_heads=None, num_classes=None) -> TransformerLM:
    """Builder (zoo registry).  `dtype` (a torch dtype or its name) casts
    the module; a TorchBundle casts it to the bundle's dtype anyway.
    `num_classes` is accepted and ignored, so the generic builder call
    sites (get_builder(name)(num_classes=...)) work."""
    m = TransformerLM(vocab_size=vocab_size, embed_dim=embed_dim,
                      num_layers=num_layers, num_heads=num_heads,
                      max_len=max_len, attn_fn=attn_fn, quant=quant,
                      moe_experts=moe_experts, moe_capacity=moe_capacity,
                      pos_emb=pos_emb, num_kv_heads=num_kv_heads)
    return m if dtype is None else m.to(_torch_dtype(dtype))


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))
