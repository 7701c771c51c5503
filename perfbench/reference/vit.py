"""Plain float32 Vision Transformer: forward, loss, gradients and SGD
steps, the reference of the fine-tuning cells.

Dosovitskiy et al., arXiv:2010.11929: a stride-P PxP convolution as the
patch embedding, a learned position table, pre-LN encoder blocks
(LayerNorm eps 1e-6; one bias-free qkv projection split as q | k | v,
softmax attention at 1/sqrt(D), a bias-free output projection; an MLP of
two biased layers around the tanh GELU), a final LayerNorm and a biased
head.  Departure from the paper, as the program does it: the head reads
the global average of the patch tokens (no class token).  Inputs are
NHWC float32 images, already resized and normalised.

The sizes come from a configuration dict in the names of the published
config (`patch_size`, `hidden_size`, `num_hidden_layers`,
`num_attention_heads`, `intermediate_size`, `num_labels`, `image_size`).
The weights are a dict of tensors under the names `param_shapes` lists.
`init_weights` draws them as the fine-tuning stage draws its initial
weights from its seed (LeCun-normal kernels in module order from one
seeded CPU generator, zero biases, unit LayerNorm scales, then the
position table at 0.02), so the reference can start where the stage
starts without taking anything the stage made.  `quant`, when given, is
applied to the input and the weight of every matrix product (the
lower-precision control), passing the gradient straight through.
Imports nothing but torch.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["param_shapes", "init_weights", "features", "logits",
           "forward_macs", "loss_and_grads", "sgd_momentum_step"]

_LN_EPS = 1e-6


def _sizes(cfg: dict):
    return (cfg["patch_size"], cfg["hidden_size"], cfg["num_hidden_layers"],
            cfg["num_attention_heads"], cfg["intermediate_size"])


def _tokens(cfg: dict) -> int:
    h, w = cfg["image_size"]
    return (h // cfg["patch_size"]) * (w // cfg["patch_size"])


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight in the stage's module order;
    kind is "conv", "dense", "bias", "ln_scale", "ln_shift" or "pos"."""
    patch, hidden, layers, _heads, mlp = _sizes(cfg)
    num_classes, n_tok = cfg["num_labels"], _tokens(cfg)
    out = [("patch_embed.weight", (hidden, 3, patch, patch), "conv"),
           ("patch_embed.bias", (hidden,), "bias")]
    for i in range(layers):
        p = f"blocks.{i}"
        out += [(f"{p}.ln1.weight", (hidden,), "ln_scale"),
                (f"{p}.ln1.bias", (hidden,), "ln_shift"),
                (f"{p}.qkv.weight", (3 * hidden, hidden), "dense"),
                (f"{p}.proj.weight", (hidden, hidden), "dense"),
                (f"{p}.ln2.weight", (hidden,), "ln_scale"),
                (f"{p}.ln2.bias", (hidden,), "ln_shift"),
                (f"{p}.mlp_in.weight", (mlp, hidden), "dense"),
                (f"{p}.mlp_in.bias", (mlp,), "bias"),
                (f"{p}.mlp_out.weight", (hidden, mlp), "dense"),
                (f"{p}.mlp_out.bias", (hidden,), "bias")]
    out += [("ln_f.weight", (hidden,), "ln_scale"),
            ("ln_f.bias", (hidden,), "ln_shift"),
            ("head.weight", (num_classes, hidden), "dense"),
            ("head.bias", (num_classes,), "bias"),
            ("pos_embed", (1, n_tok, hidden), "pos")]
    return out


def forward_macs(cfg: dict) -> int:
    """Multiply-accumulates of one image's forward from the layer shapes:
    the patch embedding, per layer the qkv, score, value, output and MLP
    products, and the head."""
    patch, e, layers, _heads, mlp = _sizes(cfg)
    s = _tokens(cfg)
    per_layer = s * e * 3 * e + 2 * s * s * e + s * e * e + 2 * s * e * mlp
    return s * e * 3 * patch * patch + layers * per_layer + e * cfg["num_labels"]


def init_weights(cfg: dict, seed: int) -> Dict[str, torch.Tensor]:
    """float32 CPU weights drawn as the stage draws its initial ones."""
    shapes = param_shapes(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    w: Dict[str, torch.Tensor] = {}
    for name, shape, kind in shapes:
        if kind in ("conv", "dense"):
            fan_in = math.prod(shape[1:])
            w[name] = torch.randn(shape, generator=gen) / fan_in ** 0.5
        elif kind == "ln_scale":
            w[name] = torch.ones(shape)
        elif kind != "pos":
            w[name] = torch.zeros(shape)
    for name, shape, kind in shapes:
        if kind == "pos":
            w[name] = 0.02 * torch.randn(shape, generator=gen)
    return w


def _ste(quant):
    if quant is None:
        return lambda t: t
    return lambda t: t + (quant(t) - t).detach()


def features(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
             quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> torch.Tensor:
    """NHWC float32 images [B, H, W, 3] -> pooled features [B, hidden]
    (the `pool` output)."""
    patch, _e, layers, heads, _mlp = _sizes(cfg)
    q = _ste(quant)

    def dense(t, name, bias=True):
        y = q(t) @ q(w[f"{name}.weight"]).t()
        return y + w[f"{name}.bias"] if bias else y

    t = F.conv2d(q(x.permute(0, 3, 1, 2).float()), q(w["patch_embed.weight"]),
                 w["patch_embed.bias"], stride=patch)
    b, e = t.shape[0], t.shape[1]
    t = t.permute(0, 2, 3, 1).reshape(b, -1, e) + w["pos_embed"]
    s, d = t.shape[1], e // heads
    for i in range(layers):
        p = f"blocks.{i}"
        y = F.layer_norm(t, (e,), w[f"{p}.ln1.weight"], w[f"{p}.ln1.bias"],
                         _LN_EPS)
        qh, kh, vh = dense(y, f"{p}.qkv", False).view(b, s, 3, heads, d
                                                       ).unbind(2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q(qh), q(kh)) / math.sqrt(d)
        a = torch.einsum("bhqk,bkhd->bqhd", q(scores.softmax(-1)), q(vh))
        t = t + dense(a.reshape(b, s, e), f"{p}.proj", False)
        y = F.layer_norm(t, (e,), w[f"{p}.ln2.weight"], w[f"{p}.ln2.bias"],
                         _LN_EPS)
        y = F.gelu(dense(y, f"{p}.mlp_in"), approximate="tanh")
        t = t + dense(y, f"{p}.mlp_out")
    t = F.layer_norm(t, (e,), w["ln_f.weight"], w["ln_f.bias"], _LN_EPS)
    return t.mean(dim=1)


def logits(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
           quant=None) -> torch.Tensor:
    """NHWC float32 images [B, H, W, 3] -> logits [B, classes]."""
    q = _ste(quant)
    return q(features(w, x, cfg, quant)) @ q(w["head.weight"]).t() \
        + w["head.bias"]


def loss_and_grads(w: Dict[str, torch.Tensor], images, labels: torch.Tensor,
                   cfg: dict, micro: int, quant=None
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The mean softmax cross-entropy of a batch and its gradient, summed
    over micro-batches of `micro` rows so that the activations fit.
    `images` is a callable giving the float32 NHWC rows [lo, hi)."""
    n = labels.shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    total = 0.0
    for lo in range(0, n, micro):
        hi = min(n, lo + micro)
        out = logits(leaves, images(lo, hi), cfg, quant)
        loss = F.cross_entropy(out.float(), labels[lo:hi].long(),
                               reduction="sum") / n
        g = torch.autograd.grad(loss, list(leaves.values()))
        for k, gk in zip(leaves, g):
            grads[k] += gk
        total += float(loss.detach())
    return total, grads


def sgd_momentum_step(w, buf, grads, lr: float, momentum: float) -> None:
    """Heavy-ball SGD in place: buf = momentum * buf + g (buf = g at the
    first step), w -= lr * buf."""
    for k, g in grads.items():
        if k not in buf:
            buf[k] = g.clone()
        else:
            buf[k].mul_(momentum).add_(g)
        w[k] = w[k] - lr * buf[k]
