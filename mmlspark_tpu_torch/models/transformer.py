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
(`module.to(dtype)`): bf16 on the card, as the JAX package runs it.  To
train as the JAX package does (bf16 compute over f32 parameters), the
trainer runs a bf16 working copy over f32 masters (models/training.py).

Attention: `default_attn` gives the flash-attention kernel
(`ops.attention_kernels.fused_attention`, differentiable through the
flash backward kernels) for CUDA tensors and its plain version, dense
`full_attention`, for CPU tensors.  Decode attends over the KV cache:

* the dense cache (a 2-tuple (k, v) [B, max_len, Hkv, D], or the int8
  4-tuple (kq, ks, vq, vs) with per-(position, head) scales), with a
  scalar `pos` (generate) or per-slot positions `pos` [B] (the
  continuous batcher's slot mode), through `_cache_attention`, plain
  PyTorch, as the JAX package leaves it to XLA;
* shared page pools [NP, page, Hkv, D] addressed by a `page_table`
  [B, MP] (the batcher's paged mode): a one-token step runs the paged
  decode kernel (`ops.paged_attention`, B7 or, over int8 pools, B8) for
  CUDA tensors and its plain version for CPU tensors; a block of s > 1
  tokens (the shared-prefix suffix prefill) gathers the pages and runs
  `_cache_attention`, as the JAX package leaves it to XLA.

The caches are written IN PLACE (the JAX package returns updated
copies; the port saves the copy) and returned.

`quant=True` builds the layers the JAX package quantizes — `qkv` (or
`q` and `kv` under GQA), `proj`, `mlp_in`, `mlp_out` and the LM `head` —
as `ops.quant.QuantLinear` (int8 weights and activations, f32 weights
kept under a bf16 module); inference only.

`moe_experts > 0` replaces every block's MLP with a Switch top-1 mixture
of experts (`_MoEMLP`, the JAX package's `_MoEMLP` arithmetic): an f32
router, capacity per row and per forward call, dropped tokens carried by
the residual.  Its load-balance loss reaches a trainer only through the
`aux` list a forward is handed (`forward(tokens, aux=[])`): each MoE
layer appends its term, and a forward without the list computes none.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import dense_cls

__all__ = ["TransformerLM", "transformer_lm", "default_attn"]

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


def _cache_attention(q, k_cache, v_cache, q_pos, d, k_scale=None,
                     v_scale=None):
    """s queries over a [B, L, H, D] cache, query (b, i) masked to cache
    positions <= q_pos[b, i] (q_pos [B|1, s]).  Returns (B, s, H, D) f32.
    With k_scale/v_scale [B, L, H] the cache is int8 and the
    per-(position, head) scale is factored out of both contractions (it
    multiplies the scores and the probabilities), as in the JAX
    package."""
    quant = k_scale is not None
    n = k_cache.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float())
    if quant:
        sc = sc * k_scale.transpose(1, 2)[:, :, None, :]
    sc = sc / math.sqrt(d)
    valid = (torch.arange(n, device=q.device)[None, None, :]
             <= q_pos[:, :, None])                       # [B|1, s, L]
    sc = sc.masked_fill(~valid[:, None, :, :], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    if quant:
        p = p * v_scale.transpose(1, 2)[:, :, None, :]
        return torch.einsum("bhqk,bkhd->bqhd", p, v_cache.float())
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v_cache.dtype).float(),
                        v_cache.float())


def _rope(x: torch.Tensor, positions: torch.Tensor,
          base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding of [B, S, H, D] q/k at `positions`, [S]
    (shared by the batch) or [B, S] (per row, slot decode): the first
    half of D rotates against the second half."""
    d2 = x.shape[-1] // 2
    inv = 1.0 / (base ** (torch.arange(d2, dtype=torch.float32,
                                       device=x.device) / d2))
    ang = positions.to(torch.float32)[..., None] * inv
    if ang.dim() == 2:                     # [S, d2] -> broadcast over B
        ang = ang[None]
    ang = ang[:, :, None, :]               # [B|1, S, 1, d2]
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


class F32Linear(nn.Linear):
    """A Linear layer whose weight and bias stay f32 under a module cast
    (`module.to(bfloat16)`), and whose input is taken in f32: the MoE
    router, which flax keeps at `dtype=float32` (a bf16 router would
    change which expert wins).  The trainer's bf16 working copy keeps it
    f32 too (`keeps_f32`)."""

    keeps_f32 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())

    def _apply(self, fn, recurse=True):
        def keep_dtype(t):
            out = fn(t)
            return out if out.dtype == t.dtype else t.to(out.device)

        return super()._apply(keep_dtype, recurse)


class _MoEMLP(nn.Module):
    """Switch top-1 mixture-of-experts MLP; flax names router (Dense with
    bias, f32), w_in [X, E, mE] and w_out [X, mE, E] (no biases).

    The JAX package's arithmetic: softmax router probabilities, the
    first-index argmax expert and its probability as the gate; capacity
    `cap = max(1, int(capacity_factor * s / X))` PER ROW (a row's routing
    never depends on its co-tenants) and per forward call; a token's
    place in its expert's queue is the cumsum along s, and tokens at or
    past `cap` are dropped (output 0; the residual carries them).  The
    expert buffers are [X, B * cap, E]: dispatch and combine are one
    `index_copy` and one `index_select` on each token's (expert, row,
    slot) address — the JAX package's one-hot einsums have exactly one
    non-zero term an output element, so indexing gives the same values
    and gradients without the [B, S, X, cap] tensors.  Dropped tokens
    address a trash row past the buffers."""

    def __init__(self, embed_dim: int, mlp_ratio: int, num_experts: int,
                 capacity_factor: float = 1.25):
        super().__init__()
        e, nx = embed_dim, num_experts
        self.num_experts = nx
        self.capacity_factor = float(capacity_factor)
        self.router = F32Linear(e, nx)
        self.w_in = nn.Parameter(torch.empty(nx, e, mlp_ratio * e))
        self.w_out = nn.Parameter(torch.empty(nx, mlp_ratio * e, e))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """flax's lecun_normal for the expert kernels: the expert axis is
        receptive field, so the fan-in is X * E (w_in) and X * mE (w_out);
        `bundle.init_state_dict` draws them the same way from a seed."""
        with torch.no_grad():
            for w in (self.w_in, self.w_out):
                w.normal_(0.0, (w.shape[0] * w.shape[1]) ** -0.5)

    def capacity(self, s: int) -> int:
        return max(1, int(self.capacity_factor * s / self.num_experts))

    def route(self, x: torch.Tensor):
        """x [B, S, E] -> (probs [B, S, X] f32, expert [B, S], gate
        [B, S] f32, queue place [B, S]; a token is kept where place < cap)."""
        probs = torch.softmax(self.router(x), dim=-1)
        gate = probs.max(dim=-1).values
        expert = probs.argmax(dim=-1)
        onehot = F.one_hot(expert, self.num_experts)
        place = (onehot.cumsum(dim=1) * onehot).sum(dim=-1) - 1
        return probs, expert, gate, place

    def experts(self, buf: torch.Tensor) -> torch.Tensor:
        """Expert buffers [X, N, E] -> [X, N, E] at buf's dtype: GELU
        (tanh) between the two expert matmuls."""
        h = F.gelu(torch.bmm(buf, self.w_in.to(buf.dtype)),
                   approximate="tanh")
        return torch.bmm(h, self.w_out.to(buf.dtype))

    def forward(self, x: torch.Tensor, aux: Optional[List] = None
                ) -> torch.Tensor:
        b, s, e = x.shape
        nx = self.num_experts
        cap = self.capacity(s)
        probs, expert, gate, place = self.route(x)
        rows = torch.arange(b, device=x.device)[:, None]
        trash = nx * b * cap
        addr = torch.where(place < cap, (expert * b + rows) * cap + place,
                           trash).reshape(-1)
        buf = x.new_zeros(trash + 1, e).index_copy(0, addr, x.reshape(-1, e))
        y = self.experts(buf[:trash].view(nx, b * cap, e)).reshape(trash, e)
        y = torch.cat([y, y.new_zeros(1, e)])
        out = y.index_select(0, addr).view(b, s, e) * gate.to(x.dtype)[..., None]
        if aux is not None:
            frac = F.one_hot(expert, nx).float().mean(dim=(0, 1))
            aux.append(nx * (frac * probs.mean(dim=(0, 1))).sum())
        return out


class _Block(nn.Module):
    """Pre-LN transformer block; flax names ln1, qkv (or q + kv), proj,
    ln2, mlp_in, mlp_out — or, with `moe_experts > 0`, moe."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int,
                 attn_fn: Optional[Callable], kv_heads: Optional[int] = None,
                 rope: bool = False, linear=nn.Linear, moe_experts: int = 0,
                 moe_capacity: float = 1.25):
        super().__init__()
        e, h = embed_dim, num_heads
        self.num_heads = h
        self.kv_heads = kv_heads or h
        self.head_dim = e // h
        self.attn_fn = attn_fn
        self.rope = rope
        self.ln1 = nn.LayerNorm(e, eps=LN_EPS)
        if self.kv_heads == h:
            self.qkv = linear(e, 3 * e, bias=False)
        else:
            self.q = linear(e, e, bias=False)
            self.kv = linear(e, 2 * self.kv_heads * self.head_dim,
                             bias=False)
        self.proj = linear(e, e, bias=False)
        self.ln2 = nn.LayerNorm(e, eps=LN_EPS)
        if moe_experts > 0:
            self.moe = _MoEMLP(e, mlp_ratio, moe_experts, moe_capacity)
        else:
            self.mlp_in = linear(e, mlp_ratio * e)
            self.mlp_out = linear(mlp_ratio * e, e)

    def forward(self, x: torch.Tensor, cache=None, pos=None, page_table=None,
                kvcache: Optional[List] = None, aux: Optional[List] = None):
        """cache=None: attention over x (the train/score/prefill path);
        `kvcache`, a list, receives this layer's (k, v) [B, S, Hkv, D] (the
        JAX package's sown 'kvcache' collection); `aux`, a list, receives
        an MoE block's load-balance loss (its sown 'losses').

        cache=(k_cache, v_cache) [B, max_len, Hkv, D], or the int8
        (kq, ks, vq, vs) with scales [B, max_len, Hkv], with an int `pos`:
        block decode — x holds the tokens at positions pos..pos+s-1, their
        K/V are written into the cache IN PLACE at `pos`, and query i
        attends over cache positions <= pos+i.

        pos [B] (a tensor): SLOT decode — row b's tokens sit at
        pos[b]..pos[b]+s-1.  With `page_table` [B, MP] the cache tuples
        are page POOLS [NP, page, Hkv, D] (+ [NP, page, Hkv] scales):
        slot b's position p lives at pool[page_table[b, p // page],
        p % page], and page 0 is the write-trash page.  Returns
        (out, cache)."""
        b, s, e = x.shape
        h, hkv, d = self.num_heads, self.kv_heads, self.head_dim
        y = self.ln1(x)
        if hkv == h:
            q, k, v = self.qkv(y).view(b, s, 3 * h, d).split(h, dim=2)
        else:
            q = self.q(y).view(b, s, h, d)
            k, v = self.kv(y).view(b, s, 2 * hkv, d).split(hkv, dim=2)
        slot = cache is not None and torch.is_tensor(pos) and pos.dim() == 1
        if self.rope:
            rp = torch.arange(s, device=x.device)
            if slot:
                rp = pos.long()[:, None] + rp[None]
            elif cache is not None:
                rp = rp + int(pos)
            q = _rope(q, rp)
            k = _rope(k, rp)
        if cache is None:
            if kvcache is not None:
                kvcache.append((k, v))
            a = self.attn_fn(q, _gqa_expand(k, h), _gqa_expand(v, h))
        elif slot:
            a = self._slot_attention(q, k, v, cache, pos, page_table)
        else:
            a = self._block_attention(q, k, v, cache, int(pos))
        a = a.to(x.dtype).reshape(b, s, e)
        x = x + self.proj(a)
        if hasattr(self, "moe"):
            out = x + self.moe(self.ln2(x), aux)
        else:
            y = self.mlp_in(self.ln2(x))
            out = x + self.mlp_out(F.gelu(y, approximate="tanh"))
        return out if cache is None else (out, cache)

    def _cache_rows(self, k, v, cache):
        """The rows this step writes, in the cache tuple's order: (k, v)
        cast to the cache dtype, or int8 (kq, ks, vq, vs)."""
        if len(cache) == 4:
            from ..ops.quant import quantize_kv_row

            kq, ks = quantize_kv_row(k)
            vq, vs = quantize_kv_row(v)
            return kq, ks, vq, vs
        return k.to(cache[0].dtype), v.to(cache[1].dtype)

    def _attend(self, q, cache, q_pos, n=None):
        """`_cache_attention` over a dense cache tuple (its first n
        positions), GQA heads repeated up to H."""
        h, d = self.num_heads, self.head_dim
        views = [_gqa_expand(c if n is None else c[:, :n], h) for c in cache]
        if len(cache) == 4:
            kq, ks, vq, vs = views
            return _cache_attention(q, kq, vq, q_pos, d, k_scale=ks,
                                    v_scale=vs)
        return _cache_attention(q, views[0], views[1], q_pos, d)

    def _block_attention(self, q, k, v, cache, pos: int):
        s = q.shape[1]
        for dst, src in zip(cache, self._cache_rows(k, v, cache)):
            dst[:, pos:pos + s] = src
        q_pos = (pos + torch.arange(s, device=q.device))[None]
        # positions past pos + s - 1 are masked for every query, so only
        # the cache up to there is read: the JAX package's result over its
        # whole static-length cache, from fewer bytes
        return self._attend(q, cache, q_pos, n=pos + s)

    def _slot_attention(self, q, k, v, cache, pos, page_table):
        b, s = q.shape[:2]
        posmat = pos.long()[:, None] + torch.arange(s, device=q.device)[None]
        rows = self._cache_rows(k, v, cache)
        if page_table is None:
            # dense slots: per-row writes; positions past the cache are
            # dropped, as JAX's scatter drops them
            keep = posmat < cache[0].shape[1]
            slots = torch.arange(b, device=q.device)[:, None].expand(b, s)
            for dst, src in zip(cache, rows):
                dst[slots[keep], posmat[keep]] = src[keep]
            return self._attend(q, cache, posmat)
        page = cache[0].shape[1]
        mp = page_table.shape[1]
        # block positions past the table (bucket padding in a suffix
        # prefill) write to the TRASH page 0: a clamped lookup would alias
        # them onto the slot's last real page and corrupt live rows
        in_range = posmat < mp * page
        pgmat = torch.where(
            in_range,
            page_table.long().gather(1, (posmat // page).clamp(max=mp - 1)),
            0)
        offmat = posmat % page
        for dst, src in zip(cache, rows):
            dst[pgmat, offmat] = src
        from ..ops import paged_attention as PA

        if s == 1:
            if len(cache) == 4:
                a = PA.paged_decode_attention_int8(q[:, 0], *cache,
                                                   page_table, pos)
            else:
                a = PA.paged_decode_attention(q[:, 0], cache[0], cache[1],
                                              page_table, pos)
            return a[:, None]
        # a block over the pages (the shared-prefix suffix prefill): gather
        # each slot's pages into a logical [B, MP * page, ...] copy
        logical = tuple(PA.gather_pages(c, page_table) for c in cache)
        return self._attend(q, logical, posmat)


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
        self.quant = bool(quant)
        self.moe_experts = int(moe_experts)
        self.moe_capacity = float(moe_capacity)
        linear = dense_cls(self.quant)
        attn = attn_fn if attn_fn is not None else default_attn(True)
        self.tok_embed = nn.Embedding(vocab_size, embed_dim)
        if pos_emb == "learned":
            self.pos_embed = nn.Embedding(max_len, embed_dim)
        self.blocks = nn.ModuleList(
            _Block(embed_dim, num_heads, mlp_ratio, attn,
                   kv_heads=num_kv_heads, rope=pos_emb == "rope",
                   linear=linear, moe_experts=moe_experts,
                   moe_capacity=moe_capacity)
            for _ in range(num_layers))
        self.ln_f = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = linear(embed_dim, vocab_size, bias=False)

    @property
    def kv_heads(self) -> int:
        """K/V head count: the head dimension of the KV cache."""
        return self.num_kv_heads or self.num_heads

    def _embed(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        """Token + learned position embeddings of tokens [B, S] at
        positions pos..pos+S-1: `pos` an int, or [B] per row (slot
        decode).  Positions past the table (bucket padding of a suffix
        prefill, which the JAX package embeds as NaN) are clamped to its
        last row: their rows are never read."""
        x = self.tok_embed(tokens)
        if self.pos_emb == "learned":
            idx = torch.arange(tokens.shape[1], device=tokens.device)
            if torch.is_tensor(pos):
                idx = (pos.long()[:, None] + idx[None]).clamp(
                    max=self.max_len - 1)
                x = x + self.pos_embed(idx)
            else:
                x = x + self.pos_embed(idx + pos)[None]
        return x

    def forward(self, tokens: torch.Tensor, train: bool = False,
                kvcache: Optional[List] = None, aux: Optional[List] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens [B, S] -> (logits [B, S, V] f32, taps).  With `kvcache`
        (a list) every layer appends its (k, v): generation's prefill.
        With `aux` (a list) every MoE layer appends its load-balance loss,
        a 0-dim f32 tensor: what the trainers add at 0.01."""
        taps: Dict[str, torch.Tensor] = {}
        x = self._embed(tokens, 0)
        taps["embed"] = x
        for block in self.blocks:
            x = block(x, kvcache=kvcache, aux=aux)
        x = self.ln_f(x)
        taps["hidden"] = x
        taps["pool"] = x.mean(dim=1).float()
        logits = self.head(x).float()
        taps["logits"] = logits
        return logits, taps

    def decode_step(self, token: torch.Tensor, cache: Sequence, pos,
                    page_table=None) -> Tuple[torch.Tensor, tuple]:
        """Block decode: token [B, s] at positions pos..pos+s-1 attends over
        the per-layer KV cache, written in place.  `pos` an int (dense
        caches) or [B] per slot; with `page_table` [B, MP] the caches are
        page pools (see `_Block.forward`).  Returns (logits [B, s, V] f32,
        cache)."""
        if not (torch.is_tensor(pos) and pos.dim() == 1):
            pos = int(pos)
        x = self._embed(token, pos)
        new_cache = []
        for block, layer_cache in zip(self.blocks, cache):
            x, layer_cache = block(x, cache=layer_cache, pos=pos,
                                   page_table=page_table)
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
