"""Autoregressive generation for TransformerLM: a KV-cached decode loop.

Counterpart of the JAX package's `models/generation.py` (`generate`),
with the bundle in place of the JAX (model, variables) pair:

  - prefill is ONE forward over the prompt, through the flash-attention
    kernel on the card; every layer hands out its K/V, which are copied
    into dense [B, max_len, Hkv, D] cache tensors;
  - the decode loop is a plain Python loop of eager `decode_step`s that
    write each new token's K/V into the caches in place and attend over
    them with the dense cache attention (`transformer._cache_attention`,
    plain PyTorch: the JAX package leaves decode attention to XLA too).
    The JAX package runs the loop as one `lax.scan`; a CUDA graph per
    step is the port's counterpart, and later work (ROADMAP A14).

Sampling semantics follow the JAX package: greedy at temperature 0;
otherwise temperature first, then top-k / top-p, then a categorical draw
from an explicit `torch.Generator` (its numbers differ from
`jax.random`'s); `eos_id` freezes a row once emitted.
`kv_cache_dtype="int8"` keeps the cache as int8 rows with f32
per-(position, head) scales (`ops.quant.quantize_kv_row`).
`beam_search` and `speculative_generate` are not ported yet (ROADMAP
A14 item 3).  A quant bundle (`quant=True`, prequantized or not) runs
as any other: the prefill runs the head over every prompt position and
each step over the batch's rows, the JAX package's row sets, which
matters because an int8 layer's activation scale is one per call.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .bundle import TorchBundle
from .transformer import TransformerLM

__all__ = ["generate"]

# (bundle_id, device) -> eval module on that device; bounded, so the
# weights of retired bundles are released
_MODULES: "OrderedDict[tuple, TransformerLM]" = OrderedDict()
_MODULES_MAX = 2


def _module_for(bundle: TorchBundle, device: torch.device) -> TransformerLM:
    key = (bundle.bundle_id, str(device))
    module = _MODULES.get(key)
    if module is None:
        module = bundle.module(device)
        if not isinstance(module, TransformerLM):
            raise TypeError(f"generate needs a TransformerLM bundle, got "
                            f"{type(module).__name__}")
        _MODULES[key] = module
        while len(_MODULES) > _MODULES_MAX:
            _MODULES.popitem(last=False)
    _MODULES.move_to_end(key)
    return module


def _filter_logits(lg: torch.Tensor, top_k: Optional[int],
                   top_p: Optional[float]) -> torch.Tensor:
    """Mask logits outside the top-k set and/or the top-p nucleus to -inf."""
    if top_k is not None and top_k < lg.shape[-1]:
        kth = torch.sort(lg, dim=-1).values[..., -top_k][..., None]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set with cumulative prob >= top_p: a token stays if the
        # mass BEFORE it (exclusive) is still < top_p
        keep = (cum - probs) < top_p
        cutoff = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                             ).min(dim=-1).values[..., None]
        lg = lg.masked_fill(lg < cutoff, float("-inf"))
    return lg


def _prefill_kv(module: TransformerLM, prompt: torch.Tensor,
                kv_cache_dtype: Optional[str] = None
                ) -> Tuple[torch.Tensor, List[tuple]]:
    """One prefill forward; returns (logits, per-layer cache rows of the
    prompt [B, S_p, Hkv, ...]: (k, v), or int8 (kq, ks, vq, vs) with
    kv_cache_dtype="int8")."""
    kv: list = []
    logits, _taps = module(prompt, kvcache=kv)
    if kv_cache_dtype == "int8":
        from ..ops.quant import quantize_kv_row

        kv = [(*quantize_kv_row(k), *quantize_kv_row(v)) for k, v in kv]
    return logits, kv


def _prefill_cache(module: TransformerLM, prompt: torch.Tensor,
                   kv_cache_dtype: Optional[str] = None
                   ) -> Tuple[torch.Tensor, tuple]:
    """One prefill forward; returns (logits, per-layer caches, each
    [B, max_len, Hkv, ...] with the prompt's rows at the front and zeros
    after: (k, v), or (kq, ks, vq, vs) with kv_cache_dtype="int8")."""
    b, s_p = prompt.shape
    logits, kv = _prefill_kv(module, prompt, kv_cache_dtype)
    cache = []
    for rows in kv:
        layer = []
        for r in rows:
            c = torch.zeros((b, module.max_len) + tuple(r.shape[2:]),
                            dtype=r.dtype, device=r.device)
            c[:, :s_p] = r
            layer.append(c)
        cache.append(tuple(layer))
    return logits, tuple(cache)


def generate(bundle: TorchBundle, prompt, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             eos_id: Optional[int] = None, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             kv_cache_dtype: Optional[str] = None,
             device=None) -> torch.Tensor:
    """prompt [B, S_p] int -> [B, S_p + max_new_tokens] int32, on the
    device the model ran on (``cuda`` unless `device` says otherwise).

    temperature == 0 is greedy argmax; > 0 samples categorically with
    `generator` (required then, on the run's device), optionally
    restricted to the `top_k` highest logits and/or the `top_p` nucleus.
    With `eos_id`, rows that emit it keep emitting it."""
    if kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"kv_cache_dtype must be None or 'int8', "
                         f"got {kv_cache_dtype!r}")
    dev = resolve_device(device)
    module = _module_for(bundle, dev)
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt)
                             else prompt).to(device=dev, dtype=torch.int32)
    b, s_p = prompt.shape
    if s_p + max_new_tokens > module.max_len:
        raise ValueError(
            f"prompt {s_p} + {max_new_tokens} new tokens exceeds "
            f"max_len {module.max_len}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a generator")
    if max_new_tokens < 1:
        return prompt

    def sample(lg: torch.Tensor) -> torch.Tensor:
        if temperature == 0.0:
            return torch.argmax(lg, dim=-1).to(torch.int32)
        # temperature FIRST, then top-k/top-p on the tempered distribution
        lg = _filter_logits(lg / temperature, top_k, top_p)
        probs = torch.softmax(lg, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    with torch.inference_mode():
        logits, cache = _prefill_cache(module, prompt, kv_cache_dtype)
        cur = logits[:, -1]
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        toks = []
        # max_new_tokens - 1 decode steps; the LAST token samples from the
        # final step's logits (a step whose logits nobody reads would be
        # a wasted forward)
        for i in range(max_new_tokens - 1):
            tok = sample(cur)
            if eos_id is not None:
                tok = torch.where(done, torch.full_like(tok, eos_id), tok)
                done = done | (tok == eos_id)
            lg, cache = module.decode_step(tok[:, None], cache, s_p + i)
            cur = lg[:, 0]
            toks.append(tok)
        last = sample(cur)
        if eos_id is not None:
            last = torch.where(done, torch.full_like(last, eos_id), last)
        toks.append(last)
        return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
