"""Plain float32 LFM2-MoE (`model_type` "lfm2_moe", LFM2-8B-A1B): forward,
next-token loss, gradients and Adam steps, the reference of the LM
training cells.

The layer equations of the `lfm2_moe` modelling code published with the
checkpoint: every layer `h = x + op(RMSNorm(x))`, `out = h +
ffn(RMSNorm(h))`, RMSNorm `w * x / sqrt(mean(x^2) + eps)`.  A "conv"
layer's `op` is the short convolution: `[B | C | x~] = in_proj(x)`, `u =
B * x~`, `v_t = sum_j w_j u_{t-L+1+j}` per channel (zeros before position
0), `out_proj(C * v)`.  A "full_attention" layer's `op`: q, k, v
projections (GQA), an RMSNorm over head_dim on each q and k head, RoPE
(first half of a head against its second half, at `rope_theta`), causal
softmax attention at 1/sqrt(head_dim) with each K/V head serving
adjacent query heads, `out_proj`.  The first `num_dense_layers` layers'
`ffn` is SwiGLU `w2(silu(w1 x) * w3 x)`; the others' a mixture of SwiGLU
experts: `s = sigmoid(router(x))`, the top `num_experts_per_tok` experts
by `s + expert_bias`, each weighted `s_e / (sum of the selected s +
1e-6)` (the published `norm_topk_prob`, `routed_scaling_factor` 1.0).
A final RMSNorm, then the head.

Departures from the published model, each as the program runs it:

* the chip's share of an expert-parallel deployment: every expert layer
  holds experts `expert_offset .. expert_offset + num_experts - 1` of the
  `published` count; the router scores and selects over all of them, and
  the pairs routed to experts not held contribute nothing;
* the head is tied to the embedding (`tie_embedding`, which the published
  config does not give);
* the expert bias is drawn from the seed, N(0, 0.01), and not trained;
* initial weights by the program's rules (`param_shapes` kinds):
  LeCun-normal kernels (an expert's over its own fan-in, the depthwise
  convolution's over its 3 taps), the embedding N(0, 1 / hidden), RMSNorm
  weights 1.

The sizes are a configuration dict in the published config's names
(`vocab_size`, `hidden_size`, `layer_types`, `num_attention_heads`,
`num_key_value_heads`, `intermediate_size`, `moe_intermediate_size`,
`num_dense_layers`, `num_experts` held, `num_experts_per_tok`,
`norm_eps`, `rope_theta`, `conv_L_cache`), `published["num_experts"]` and
`expert_offset`.  Weights are a dict of tensors under the program's leaf
names.  `quant`, when given, is applied to the input and the weight of
every matrix product (the lower-precision control), passing the gradient
straight through.  With `checkpoint` every layer, and every block of
`ATTN_BLOCK` queries, is recomputed in the backward, so that a long
sequence fits.  `routes`, when given, holds a selection for each expert
layer ([B * S, k] expert ids, by the layer's name prefix): the layer
takes it in place of its own top-k, so that two computations at one
state make the same discrete choices (a token near the top-k boundary
flips with the rounding of its router input).  Imports nothing but
torch.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

__all__ = ["param_shapes", "trainable", "init_weights", "logits",
           "lm_loss", "loss_and_grads", "adam_step", "forward_macs"]

ATTN_BLOCK = 1024  # queries a block of the attention


def _cut(cfg: dict) -> Tuple[int, int, int]:
    """(experts held, first held expert, experts routed over)."""
    held = int(cfg["num_experts"])
    routed = int(cfg.get("published", {}).get("num_experts", held))
    return held, int(cfg.get("expert_offset", 0)), routed


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight, in the order the program
    draws them; kind is "embed", "dense", "conv", "norm", "expert" or
    "expert_bias"."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    held, _off, routed = _cut(cfg)
    fm, L = cfg["moe_intermediate_size"], cfg["conv_L_cache"]
    out = [("embed_tokens.weight", (v, d), "embed")]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}."
        out.append((p + "operator_norm.weight", (d,), "norm"))
        if kind == "conv":
            out += [(p + "conv.in_proj.weight", (3 * d, d), "dense"),
                    (p + "conv.conv.weight", (d, 1, L), "conv"),
                    (p + "conv.out_proj.weight", (d, d), "dense")]
        else:
            a = p + "self_attn."
            out += [(a + "q_proj.weight", (h * hd, d), "dense"),
                    (a + "k_proj.weight", (hkv * hd, d), "dense"),
                    (a + "v_proj.weight", (hkv * hd, d), "dense"),
                    (a + "out_proj.weight", (d, h * hd), "dense"),
                    (a + "q_layernorm.weight", (hd,), "norm"),
                    (a + "k_layernorm.weight", (hd,), "norm")]
        out.append((p + "ffn_norm.weight", (d,), "norm"))
        f = p + "feed_forward."
        if i < cfg["num_dense_layers"]:
            fd = cfg["intermediate_size"]
            out += [(f + "w1.weight", (fd, d), "dense"),
                    (f + "w3.weight", (fd, d), "dense"),
                    (f + "w2.weight", (d, fd), "dense")]
        else:
            out += [(f + "w1", (held, fm, d), "expert"),
                    (f + "w3", (held, fm, d), "expert"),
                    (f + "w2", (held, d, fm), "expert"),
                    (f + "gate.weight", (routed, d), "dense"),
                    (f + "gate.expert_bias", (routed,), "expert_bias")]
    out.append(("embedding_norm.weight", (d,), "norm"))
    return out


def trainable(cfg: dict) -> List[str]:
    """The names the optimizer steps (all but the expert biases)."""
    return [n for n, _s, kind in param_shapes(cfg) if kind != "expert_bias"]


def init_weights(cfg: dict, seed: int) -> Dict[str, torch.Tensor]:
    """float32 CPU weights, drawn from one seeded CPU generator in the
    program's order by its rules."""
    gen = torch.Generator().manual_seed(int(seed))
    w: Dict[str, torch.Tensor] = {}
    for name, shape, kind in param_shapes(cfg):
        if kind == "norm":
            w[name] = torch.ones(shape)
            continue
        z = torch.randn(shape, generator=gen)
        if kind == "expert_bias":
            w[name] = z * 0.01
        elif kind == "embed":
            w[name] = z / shape[1] ** 0.5
        else:  # a kernel over its fan-in: a row of a dense or conv weight,
            # one expert's input features
            w[name] = z / (math.prod(shape[1:]) if kind != "expert"
                           else shape[-1]) ** 0.5
    return w


def _ste(quant):
    if quant is None:
        return lambda t: t
    # an expert no token chose multiplies empty operands: nothing to round
    return lambda t: t + (quant(t) - t).detach() if t.numel() else t


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """[B, S, H, D] at positions 0..S-1: the first half of D against the
    second half."""
    s, d2 = x.shape[1], x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(d2, dtype=torch.float32,
                                       device=x.device) / d2)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(q_blk, k, v, lo: int, q) -> torch.Tensor:
    """Queries lo.. of q_blk [B, n, H, D] over keys 0..lo+n-1, causal."""
    n, m = q_blk.shape[1], k.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q(q_blk), q(k)) \
        / math.sqrt(q_blk.shape[-1])
    pos = torch.arange(lo, lo + n, device=sc.device)[:, None]
    sc = sc.masked_fill(pos < torch.arange(m, device=sc.device)[None],
                        float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", q(sc.softmax(-1)), q(v))


class _Ctx:
    def __init__(self, w, cfg, quant, ckpt, routes=None, rows=slice(None)):
        self.w, self.cfg, self.q, self.ckpt = w, cfg, _ste(quant), ckpt
        self.eps = float(cfg["norm_eps"])
        self.routes, self.rows = routes, rows
        self.held_pairs = 0
        self.chosen: Dict[str, torch.Tensor] = {}  # own top-k by layer
        self.counted = set()  # layers counted (a recompute counts none)

    def dense(self, x, name):
        return self.q(x) @ self.q(self.w[name]).t()

    def run(self, fn, *args):
        if self.ckpt:
            return _checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)


def _conv(c: _Ctx, p: str, x):
    b, cc, xt = c.dense(x, p + "in_proj.weight").chunk(3, dim=-1)
    u = b * xt
    wc = c.w[p + "conv.weight"][:, 0, :]
    L, s = wc.shape[1], u.shape[1]
    up = F.pad(u, (0, 0, L - 1, 0))
    v = sum(wc[:, j] * up[:, j:j + s] for j in range(L))
    return c.dense(cc * v, p + "out_proj.weight")


def _attention(c: _Ctx, p: str, x):
    cfg = c.cfg
    b, s, _ = x.shape
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["hidden_size"] // h
    qh = c.dense(x, p + "q_proj.weight").view(b, s, h, d)
    kh = c.dense(x, p + "k_proj.weight").view(b, s, hkv, d)
    vh = c.dense(x, p + "v_proj.weight").view(b, s, hkv, d)
    qh = _rope(_rms(qh, c.w[p + "q_layernorm.weight"], c.eps),
               float(cfg["rope_theta"]))
    kh = _rope(_rms(kh, c.w[p + "k_layernorm.weight"], c.eps),
               float(cfg["rope_theta"]))
    kh = kh.repeat_interleave(h // hkv, dim=2)
    vh = vh.repeat_interleave(h // hkv, dim=2)
    blocks = [c.run(lambda qb, kb, vb, lo=lo: _attend(qb, kb, vb, lo, c.q),
                    qh[:, lo:lo + ATTN_BLOCK], kh[:, :lo + ATTN_BLOCK],
                    vh[:, :lo + ATTN_BLOCK])
              for lo in range(0, s, ATTN_BLOCK)]
    a = torch.cat(blocks, dim=1).reshape(b, s, h * d)
    return c.dense(a, p + "out_proj.weight")


def _swiglu(c: _Ctx, x, w1, w3, w2):
    q = c.q
    h = F.silu(q(x) @ q(w1).t()) * (q(x) @ q(w3).t())
    return q(h) @ q(w2).t()


def _experts(c: _Ctx, p: str, x):
    cfg = c.cfg
    held, off, _routed = _cut(cfg)
    shape = x.shape
    t = x.reshape(-1, shape[-1])
    scores = torch.sigmoid(c.dense(t, p + "gate.weight"))
    expert = torch.topk(scores + c.w[p + "gate.expert_bias"],
                        int(cfg["num_experts_per_tok"]), dim=-1).indices
    if p not in c.counted:
        c.chosen[p] = expert.detach()
    if c.routes is not None:
        expert = c.routes[p][c.rows].to(expert.device, torch.long)
    weight = scores.gather(1, expert)
    weight = weight / (weight.sum(-1, keepdim=True) + 1e-6)
    out = torch.zeros_like(t)
    if p not in c.counted:
        c.counted.add(p)
        c.held_pairs += int(((expert >= off) & (expert < off + held)).sum())
    for e in range(held):
        tok, slot = (expert == off + e).nonzero(as_tuple=True)
        y = _swiglu(c, t[tok], c.w[p + "w1"][e], c.w[p + "w3"][e],
                    c.w[p + "w2"][e])
        out = out.index_add(0, tok, y * weight[tok, slot][:, None])
    return out.view(shape)


def _layer(c: _Ctx, i: int, x):
    p = f"layers.{i}."
    y = _rms(x, c.w[p + "operator_norm.weight"], c.eps)
    if c.cfg["layer_types"][i] == "conv":
        h = x + _conv(c, p + "conv.", y)
    else:
        h = x + _attention(c, p + "self_attn.", y)
    y = _rms(h, c.w[p + "ffn_norm.weight"], c.eps)
    f = p + "feed_forward."
    if i < c.cfg["num_dense_layers"]:
        return h + _swiglu(c, y, c.w[f + "w1.weight"], c.w[f + "w3.weight"],
                           c.w[f + "w2.weight"])
    return h + _experts(c, f, y)


def _logits(c: _Ctx, tokens: torch.Tensor) -> torch.Tensor:
    emb = c.w["embed_tokens.weight"]
    x = emb[tokens.long()]
    for i in range(len(c.cfg["layer_types"])):
        x = c.run(lambda x, i=i: _layer(c, i, x), x)
    x = _rms(x, c.w["embedding_norm.weight"], c.eps)
    return c.q(x) @ c.q(emb).t()


def logits(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict,
           quant: Optional[Callable] = None) -> torch.Tensor:
    """tokens [B, S] -> float32 logits [B, S, vocab]."""
    return _logits(_Ctx(w, cfg, quant, False), tokens)


def lm_loss(logits_: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of logits[:, :-1] against
    tokens[:, 1:]."""
    v = logits_.shape[-1]
    return F.cross_entropy(logits_[:, :-1].reshape(-1, v),
                           tokens[:, 1:].reshape(-1).long())


def loss_and_grads(w: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   cfg: dict, quant: Optional[Callable] = None,
                   checkpoint: bool = False,
                   routes: Optional[Dict[str, torch.Tensor]] = None,
                   chosen: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[float, Dict[str, torch.Tensor], int]:
    """(mean loss of the batch, its gradient by trainable name, the
    (token, slot) pairs the held experts computed), one sequence at a
    time with the gradients summed.  Each expert layer takes its
    selection from `routes` when given; `chosen`, when given, receives
    the layers' own top-k selections ([B * S, k] by layer, the form
    `routes` takes)."""
    names = trainable(cfg)
    leaves = {k: v.detach().requires_grad_(k in names) for k, v in w.items()}
    grads = {k: torch.zeros_like(w[k]) for k in names}
    n, s = tokens.shape
    total, pairs, own = 0.0, 0, []
    for r in range(n):
        c = _Ctx(leaves, cfg, quant, checkpoint, routes,
                 slice(r * s, (r + 1) * s))
        loss = lm_loss(_logits(c, tokens[r:r + 1]), tokens[r:r + 1]) / n
        for k, g in zip(names, torch.autograd.grad(
                loss, [leaves[k] for k in names])):
            grads[k] += g
        total += float(loss.detach())
        pairs += c.held_pairs
        own.append(c.chosen)
    if chosen is not None:
        chosen.update({p: torch.cat([o[p] for o in own]) for p in own[0]})
    return total, grads, pairs


def adam_step(w: Dict[str, torch.Tensor], opt: dict,
              grads: Dict[str, torch.Tensor], lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> None:
    """optax.adam in place: m and v (in `opt`, with its step count) from
    the gradient, the bias-corrected step `lr * m^ / (sqrt(v^) + eps)`."""
    opt["step"] = t = opt.get("step", 0) + 1
    m, v = opt.setdefault("m", {}), opt.setdefault("v", {})
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    with torch.no_grad():
        for k, g in grads.items():
            if k not in m:
                m[k], v[k] = torch.zeros_like(g), torch.zeros_like(g)
            m[k].mul_(b1).add_(g, alpha=1 - b1)
            v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v[k] / c2).sqrt_().add_(eps)
            w[k].addcdiv_(m[k], denom, value=-lr / c1)


def forward_macs(cfg: dict, held_pairs: int, seq_len: int,
                 sequences: int = 1) -> float:
    """Multiply-accumulates of the forward of `sequences` sequences of
    `seq_len` tokens from the layer shapes: the conv layers' projections
    and taps, the attention layers' projections and their causal score
    and value products (query t over keys 0..t), the dense FFNs, the
    router, the experts from the `held_pairs` (token, slot) pairs they
    computed in those forwards, all layers together, and the head."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    _held, _off, routed = _cut(cfg)
    kinds = cfg["layer_types"]
    n_attn = sum(1 for k in kinds if k == "full_attention")
    n_conv = len(kinds) - n_attn
    n_dense = cfg["num_dense_layers"]
    per_token = (n_conv * (4 * d * d + cfg["conv_L_cache"] * d)
                 + n_attn * (2 * d * h * hd + 2 * d * hkv * hd)
                 + n_dense * 3 * d * cfg["intermediate_size"]
                 + (len(kinds) - n_dense) * d * routed + d * v)
    causal = n_attn * 2 * h * hd * seq_len * (seq_len + 1) / 2
    experts = held_pairs * 3 * d * cfg["moe_intermediate_size"]
    return float(sequences * (per_token * seq_len + causal) + experts)
