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

`beam_search` follows the JAX package's: one prefill on B rows whose
cache is repeated K times, a [B, K*V] top-k a step taken from a STABLE
descending sort (ties go to the lower index, as `lax.top_k` orders them;
`torch.topk` leaves their order open), the cache reordered by the chosen
beams with `index_select` (a new tensor: an in-place reorder through a
view would alias beams), finished beams frozen to `eos_id` at zero cost,
a best-finished buffer ranked by GNMT length normalisation, and the
dead tail padded with `eos_id`.

`speculative_generate` (batch 1) runs gamma + 1 draft steps a round —
the last only writes the draft's K/V row of its gamma-th proposal — and
ONE target block decode of the pending token and the gamma proposals
at the scalar position, through the dense-cache block path; it accepts
the longest matching prefix and then emits the target's own token, so
its tokens are the target's greedy tokens.  A round reads its proposals
and the target's predictions back once.  A rejected tail's cache rows
are overwritten by the next round's writes before any query reads them.

A quant bundle (`quant=True`, prequantized or not) runs
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

__all__ = ["generate", "beam_search", "speculative_generate"]

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


def _as_prompt(prompt, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt)
                           else prompt).to(device=dev, dtype=torch.int32)


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
    prompt = _as_prompt(prompt, dev)
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


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The k largest of each row and their indices, ties in index order
    (`jax.lax.top_k`'s order), from a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(bundle: TorchBundle, prompt, max_new_tokens: int,
                num_beams: int = 4, length_penalty: float = 1.0,
                eos_id: Optional[int] = None,
                kv_cache_dtype: Optional[str] = None,
                device=None) -> torch.Tensor:
    """Beam-search decode: prompt [B, S_p] -> [B, S_p + max_new_tokens]
    int32, on the device the model ran on.

    Hypotheses are ranked by score / len**length_penalty (GNMT
    normalisation; 0.0 ranks by the raw sum of log-probabilities).
    Pruning is by raw score, so a finished hypothesis can leave the live
    beams: every beam that finishes is also kept in a per-row
    best-finished buffer, and the answer is the better of the best live
    and the best finished hypothesis."""
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"kv_cache_dtype must be None or 'int8', "
                         f"got {kv_cache_dtype!r}")
    dev = resolve_device(device)
    module = _module_for(bundle, dev)
    prompt = _as_prompt(prompt, dev)
    b, s_p = prompt.shape
    k_beams = int(num_beams)
    n = int(max_new_tokens)
    if s_p + n > module.max_len:
        raise ValueError(
            f"prompt {s_p} + {n} new tokens exceeds max_len {module.max_len}")
    if n < 1:
        return prompt
    v_size = module.vocab_size
    pen = float(length_penalty)
    rows = torch.arange(b, device=dev)[:, None]                   # [B, 1]
    ninf = float("-inf")

    def select(scores, seqs, done, gen_len, cur_logp, t):
        """One beam expansion at step t: the [B, K*V] top-k and the
        state reordered by the chosen beams."""
        logp = cur_logp
        if eos_id is not None:
            # finished beams may only continue with eos, at zero cost
            frozen = torch.full((v_size,), ninf, device=dev)
            frozen[eos_id] = 0.0
            logp = torch.where(done[..., None], frozen, logp)
        cand = scores[..., None] + logp                           # [B, K, V]
        vals, idx = _top_k_stable(cand.reshape(b, -1), k_beams)
        beam = idx // v_size                                      # [B, K]
        tok = (idx % v_size).to(torch.int32)
        seqs = seqs[rows, beam]
        seqs[:, :, t] = tok
        prev_done = done[rows, beam]
        gen_len = gen_len[rows, beam]
        if eos_id is not None:
            gen_len = torch.where(prev_done, gen_len, t + 1)
            newly = ~prev_done & (tok == eos_id)
            done = prev_done | newly
        else:
            gen_len = torch.full_like(gen_len, t + 1)
            newly = torch.zeros_like(prev_done)
            done = prev_done
        return vals, seqs, done, gen_len, beam, newly

    def normalised(scores, gen_len):
        return scores / gen_len.clamp(min=1).float() ** pen

    def update_finished(best_norm, best_seq, scores, seqs, gen_len, newly):
        cand = torch.where(newly, normalised(scores, gen_len), ninf)
        arg = cand.argmax(dim=1)
        cand_best = cand[rows[:, 0], arg]
        better = cand_best > best_norm
        best_norm = torch.where(better, cand_best, best_norm)
        best_seq = torch.where(better[:, None], seqs[rows[:, 0], arg],
                               best_seq)
        return best_norm, best_seq

    with torch.inference_mode():
        logits, cache = _prefill_cache(module, prompt, kv_cache_dtype)
        # each row's cache repeated across its K beams: rows b0 b0 .. b1 ..
        cache = tuple(tuple(c.repeat_interleave(k_beams, dim=0)
                            for c in layer) for layer in cache)
        logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)  # [B, V]
        cur_logp = logp0[:, None].expand(b, k_beams, v_size)
        # only beam 0 is live at first, so the first top-k picks K
        # distinct first tokens instead of K copies of the argmax
        scores = torch.full((b, k_beams), ninf, device=dev)
        scores[:, 0] = 0.0
        seqs = torch.zeros((b, k_beams, n), dtype=torch.int32, device=dev)
        done = torch.zeros((b, k_beams), dtype=torch.bool, device=dev)
        gen_len = torch.zeros((b, k_beams), dtype=torch.int32, device=dev)
        best_norm = torch.full((b,), ninf, device=dev)
        best_seq = torch.zeros((b, n), dtype=torch.int32, device=dev)
        # n - 1 expansions with a decode step after each; the last one
        # needs none (its logits would go unread)
        for t in range(n):
            scores, seqs, done, gen_len, beam, newly = select(
                scores, seqs, done, gen_len, cur_logp, t)
            best_norm, best_seq = update_finished(
                best_norm, best_seq, scores, seqs, gen_len, newly)
            if t == n - 1:
                break
            flat_sel = (rows * k_beams + beam).reshape(-1)        # [B*K]
            cache = tuple(tuple(c.index_select(0, flat_sel) for c in layer)
                          for layer in cache)
            lg, cache = module.decode_step(seqs[:, :, t].reshape(-1, 1),
                                           cache, s_p + t)
            cur_logp = torch.log_softmax(lg[:, 0].float(), dim=-1).reshape(
                b, k_beams, v_size)
        live_norm = normalised(scores, gen_len)
        live_arg = live_norm.argmax(dim=1)
        live_best = live_norm[rows[:, 0], live_arg]
        out = torch.where((best_norm > live_best)[:, None], best_seq,
                          seqs[rows[:, 0], live_arg])
        if eos_id is not None:
            # a buffered hypothesis holds zeros past its eos: pad the
            # dead tail with eos
            seen = (out == eos_id).cumsum(dim=1) > 0
            out = torch.where(seen, torch.full_like(out, eos_id), out)
        return torch.cat([prompt, out], dim=1)


def speculative_generate(bundle: TorchBundle, draft_bundle: TorchBundle,
                         prompt, max_new_tokens: int, gamma: int = 4,
                         eos_id: Optional[int] = None,
                         return_stats: bool = False, device=None):
    """Greedy speculative decoding: prompt [1, S_p] -> [1, S_p +
    max_new_tokens] int32, EXACTLY the target's greedy tokens; with
    `return_stats`, (tokens, rounds), the target forwards taken after
    the prefill ((n - 1) / rounds tokens accepted a verify; a perfect
    draft takes ceil((n - 1) / (gamma + 1))).

    The draft must share the target's vocabulary: a smaller model, a
    distilled student (`training.make_distill_epoch`) or the target's
    prequantized int8 copy (`bundle.prequantize`)."""
    dev = resolve_device(device)
    module = _module_for(bundle, dev)
    draft = _module_for(draft_bundle, dev)
    prompt = _as_prompt(prompt, dev)
    if prompt.shape[0] != 1:
        raise ValueError("speculative_generate supports batch size 1 "
                         f"(got {prompt.shape[0]}); decode streams "
                         "independently in serving")
    if draft.vocab_size != module.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    n = int(max_new_tokens)
    s_p = prompt.shape[1]
    g = int(gamma)
    if s_p + n > module.max_len:
        raise ValueError(
            f"prompt {s_p} + {n} new tokens exceeds max_len {module.max_len}")
    if n < 1:
        return prompt
    # the verify block may run up to g ahead of the emitted length
    if s_p + n + g > module.max_len or s_p + n + g > draft.max_len:
        raise ValueError(
            f"speculative decode needs max_len >= prompt + new + gamma "
            f"({s_p}+{n}+{g}) on both models")

    with torch.inference_mode():
        t_logits, t_cache = _prefill_cache(module, prompt)
        _d_logits, d_cache = _prefill_cache(draft, prompt)
        # the first token comes from the target's prefill: y is always
        # decided but not yet fed, at position p
        y = t_logits[:, -1].argmax(-1).to(torch.int32)               # [1]
        out = [int(y[0])]
        p, rounds = s_p, 0
        while len(out) < n:
            # g draft steps from y at p, plus one that only writes d_g's
            # K/V at p + g: without it a fully accepted round leaves a
            # hole there that later draft queries attend over
            tok, props = y[:, None], []
            for i in range(g + 1):
                lg, d_cache = draft.decode_step(tok, d_cache, p + i)
                tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                if i < g:
                    props.append(tok[:, 0])
            d_toks = torch.cat(props)                                 # [g]
            # ONE target forward verifies y and the g proposals:
            # logits[j] predicts position p + j + 1
            block = torch.cat([y, d_toks])[None]                  # [1, g+1]
            lg, t_cache = module.decode_step(block, t_cache, p)
            t_pred = lg[0].argmax(-1).to(torch.int32)                # [g+1]
            both = torch.cat([d_toks, t_pred]).cpu().numpy()
            d_host, t_host = both[:g], both[g:]
            match = np.append(t_host[:g] == d_host, False)
            m = int(np.argmin(match))                                # 0..g
            out += [int(t) for t in d_host[:m]] + [int(t_host[m])]
            y = t_pred[m:m + 1]
            p += m + 1
            rounds += 1
        toks = torch.tensor([out[:n]], dtype=torch.int32, device=dev)
        if eos_id is not None:
            # generate's eos freeze: everything after the first eos is eos
            seen = (toks == eos_id).cumsum(dim=1) > 0
            toks = torch.where(seen, torch.full_like(toks, eos_id), toks)
        result = torch.cat([prompt, toks], dim=1)
    return (result, rounds) if return_stats else result
