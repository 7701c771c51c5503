"""Vision Transformer backbones for the model zoo.

Counterpart of the JAX package's `models/vit.py` (flax): NHWC images in,
one stride-P PxP conv as the patch embedding, a learned position table,
the same pre-LN `_Block` as TransformerLM with non-causal attention, GAP
pooling (no CLS token, so S = (H/P)(W/P), 196 at 224x224).  Taps
["logits", "pool", "encoded", "embed"], as in the JAX package.

Two layout points: the torch conv gives (B, E, gh, gw), which is permuted
to flax's (B, gh, gw, E) before it is flattened to (B, gh*gw, E) —
otherwise patches would meet the wrong rows of `pos_embed`; and the
position table's size depends on the image size, so the module is built
for one `image_size` (a TorchBundle passes its input_shape's).

`quant=True` runs the encoder blocks' linear layers as int8
(`ops.quant.QuantLinear`); the classification `head` stays a plain
linear layer, as in the JAX package.  `moe_experts > 0` is the V-MoE
variant: every encoder MLP is the Switch mixture of experts of
TransformerLM (`transformer._MoEMLP`, capacity factor 1.25, the JAX
package's default), whose load-balance loss a forward appends to the
`aux` list it is handed.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..ops.quant import dense_cls
from .transformer import LN_EPS, _Block, _torch_dtype, default_attn

__all__ = ["VisionTransformer", "vit_tiny", "vit_small", "vit_base"]


def _pair(size: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (int(size), int(size)) if isinstance(size, int) else tuple(
        int(s) for s in size)


def _check_divisible(h: int, w: int, p: int) -> None:
    if h % p or w % p:
        raise ValueError(
            f"ViT needs input H/W divisible by patch_size={p}; got {h}x{w} — "
            "resize (ImageFeaturizer does this automatically from "
            "bundle.input_shape)")


class VisionTransformer(nn.Module):
    """ViT over NHWC images; GAP pooling, pre-LN encoder blocks.

    `attn_fn` (q, k, v) -> f32 replaces the default attention
    (`transformer.default_attn(False)`), as TransformerLM's does."""

    layer_names = ["logits", "pool", "encoded", "embed"]

    def __init__(self, patch_size: int = 16, embed_dim: int = 192,
                 num_layers: int = 12, num_heads: int = 3,
                 mlp_ratio: int = 4, num_classes: int = 1000,
                 quant: bool = False, moe_experts: int = 0,
                 image_size: Union[int, Tuple[int, int]] = 224,
                 attn_fn: Optional[Callable] = None):
        super().__init__()
        p = int(patch_size)
        h, w = _pair(image_size)
        _check_divisible(h, w, p)
        self.patch_size = p
        self.image_size = (h, w)
        self.moe_experts = int(moe_experts)
        attn = attn_fn if attn_fn is not None else default_attn(False)
        self.patch_embed = nn.Conv2d(3, embed_dim, p, stride=p)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, (h // p) * (w // p), embed_dim))
        self.blocks = nn.ModuleList(
            _Block(embed_dim, num_heads, mlp_ratio, attn,
                   linear=dense_cls(quant), moe_experts=moe_experts)
            for _ in range(num_layers))
        self.ln_f = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = nn.Linear(embed_dim, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                aux: Optional[List] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x: [B, H, W, 3] (NHWC, any float or uint8 dtype).  With `aux`
        (a list) every MoE block appends its load-balance loss."""
        p = self.patch_size
        _check_divisible(x.shape[1], x.shape[2], p)
        if tuple(x.shape[1:3]) != self.image_size:
            raise ValueError(
                f"this ViT was built for {self.image_size[0]}x"
                f"{self.image_size[1]} images (its pos_embed), got "
                f"{x.shape[1]}x{x.shape[2]}")
        taps: Dict[str, torch.Tensor] = {}
        dtype = self.patch_embed.weight.dtype
        x = self.patch_embed(x.permute(0, 3, 1, 2).to(dtype))  # [B, E, gh, gw]
        x = x.permute(0, 2, 3, 1)                             # flax's NHWC
        b, gh, gw, e = x.shape
        x = x.reshape(b, gh * gw, e) + self.pos_embed.to(dtype)
        taps["embed"] = x
        for block in self.blocks:
            x = block(x, aux=aux)
        x = self.ln_f(x)
        taps["encoded"] = x
        pooled = x.mean(dim=1)
        taps["pool"] = pooled.float()
        logits = self.head(pooled).float()
        taps["logits"] = logits
        return logits, taps


def _vit(embed_dim, num_heads, num_classes, dtype, patch_size, quant,
         image_size, attn_fn) -> VisionTransformer:
    m = VisionTransformer(patch_size=patch_size, embed_dim=embed_dim,
                          num_layers=12, num_heads=num_heads,
                          num_classes=num_classes, quant=quant,
                          image_size=image_size, attn_fn=attn_fn)
    return m if dtype is None else m.to(_torch_dtype(dtype))


def vit_tiny(num_classes=1000, dtype=None, patch_size=16, quant=False,
             image_size=224, attn_fn=None):
    return _vit(192, 3, num_classes, dtype, patch_size, quant, image_size,
                attn_fn)


def vit_small(num_classes=1000, dtype=None, patch_size=16, quant=False,
              image_size=224, attn_fn=None):
    return _vit(384, 6, num_classes, dtype, patch_size, quant, image_size,
                attn_fn)


def vit_base(num_classes=1000, dtype=None, patch_size=16, quant=False,
             image_size=224, attn_fn=None):
    return _vit(768, 12, num_classes, dtype, patch_size, quant, image_size,
                attn_fn)
