"""BiLSTM sequence tagger with bucketed padding, on the card.

Reference capability: the "Medical Entity Extraction" BiLSTM notebook served
through CNTK dynamic axes (SURVEY §5 long-context note).  Counterpart of
the JAX package's `models/bilstm.py`, with its Params, defaults, output
column, vocabularies and bucket helpers (`bucket_length`,
`pad_to_buckets`, copied).  The JAX package pads variable-length rows to
a few bucket lengths for XLA's static shapes; the port keeps the buckets
(the same batches in the same order, so the same Adam steps), and runs
each as packed sequences.

`BiLSTMTagger` is `nn.Embedding` -> a bidirectional `nn.LSTM` ->
`nn.Linear`.  The reverse direction reads each row backwards within its
length (flax's `reverse=True, keep_order=True, seq_lengths`), which is
what packed sequences do; a row with no tokens runs as one padding token
and gives `[]`.  Flax's `OptimizedLSTMCell` keeps input kernels
`ii/if/ig/io` without bias and recurrent kernels `hi/hf/hg/ho` with
bias, in the gate order (i, f, g, o) of `nn.LSTM`, and `c' = f c + i g`
on both sides, so `weight_ih = [ii; if; ig; io]ᵀ`, `weight_hh =
[hi; hf; hg; ho]ᵀ`, `bias_hh` = the four `h*` biases and `bias_ih` = 0,
kept at 0 (it is not trained: Adam would move the two biases apart from
flax's one).  `from_flax_params` / `to_flax_params` map the two layouts,
and `SequenceTaggerModel.model_params` stays a numpy tree in flax's
layout, so a model fitted by the JAX package transforms here.

The fit is the reference's: masked mean softmax cross-entropy, Adam
(`torch.optim.Adam`, optax.adam's arithmetic), one step per bucket in the
order of `pad_to_buckets`' dict, `epochs` times.  The dense products run
in full f32 (`models/linear._full_f32`); cuDNN's LSTM on the card runs
in its default math.  Each stage has a `device` Param: the card unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table
from ..device import DEVICE_DOC, resolve_device

__all__ = ["BiLSTMTagger", "SequenceTagger", "SequenceTaggerModel",
           "bucket_length", "pad_to_buckets", "from_flax_params",
           "to_flax_params"]

DEFAULT_BUCKETS = (16, 32, 64, 128, 256)
_GATES = ("i", "f", "g", "o")


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n; sequences beyond the last bucket get an exact
    bucket of their own length (an extra compile, never silent truncation)."""
    for b in buckets:
        if n <= b:
            return b
    return n


def pad_to_buckets(seqs: List[np.ndarray],
                   buckets: Sequence[int] = DEFAULT_BUCKETS,
                   pad_value: int = 0):
    """Group sequences by bucket: {bucket: (ids (B,L), lengths (B,), rows)}.

    One jit compile per bucket instead of per distinct length.
    """
    groups: Dict[int, List[int]] = {}
    for i, s in enumerate(seqs):
        groups.setdefault(bucket_length(len(s), buckets), []).append(i)
    out = {}
    for b, rows in groups.items():
        ids = np.full((len(rows), b), pad_value, np.int32)
        lens = np.zeros(len(rows), np.int32)
        for j, r in enumerate(rows):
            s = np.asarray(seqs[r][:b], np.int32)
            ids[j, : len(s)] = s
            lens[j] = len(s)
        out[b] = (ids, lens, np.asarray(rows))
    return out


class BiLSTMTagger(nn.Module):
    """Embedding -> BiLSTM -> per-token tag logits."""

    def __init__(self, vocab_size: int, num_tags: int, embed_dim: int = 64,
                 hidden: int = 128):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.lstm = nn.LSTM(embed_dim, hidden, batch_first=True,
                            bidirectional=True)
        self.dense = nn.Linear(2 * hidden, num_tags)
        with torch.no_grad():
            for name in ("bias_ih_l0", "bias_ih_l0_reverse"):
                getattr(self.lstm, name).zero_().requires_grad_(False)

    def forward(self, token_ids: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        """token_ids [B, L] int, lengths [B] -> logits [B, L, num_tags]
        (the positions past a row's length are 0 before the dense
        layer)."""
        x = self.embed(token_ids.long())
        packed = pack_padded_sequence(
            x, lengths.detach().cpu().long().clamp(min=1), batch_first=True,
            enforce_sorted=False)
        h, _ = self.lstm(packed)
        h, _ = pad_packed_sequence(h, batch_first=True,
                                   total_length=token_ids.shape[1])
        return self.dense(h)


def from_flax_params(params: Mapping, module: BiLSTMTagger) -> None:
    """Load a flax BiLSTMTagger's `params` numpy tree into `module` in
    place.  Raises KeyError on any flax leaf that maps nowhere or any
    trained weight no leaf fills, ValueError on a shape mismatch."""
    out: Dict[str, np.ndarray] = {}
    used = set()

    def take(*path):
        node = params
        for p in path:
            node = node[p]
        used.add(path)
        return np.asarray(node, np.float32)

    out["embed.weight"] = take("Embed_0", "embedding")
    out["dense.weight"] = take("Dense_0", "kernel").T
    out["dense.bias"] = take("Dense_0", "bias")
    for cell, sfx in (("OptimizedLSTMCell_0", ""),
                      ("OptimizedLSTMCell_1", "_reverse")):
        out[f"lstm.weight_ih_l0{sfx}"] = np.concatenate(
            [take(cell, f"i{g}", "kernel") for g in _GATES], axis=1).T
        out[f"lstm.weight_hh_l0{sfx}"] = np.concatenate(
            [take(cell, f"h{g}", "kernel") for g in _GATES], axis=1).T
        out[f"lstm.bias_hh_l0{sfx}"] = np.concatenate(
            [take(cell, f"h{g}", "bias") for g in _GATES])
    flat = set()

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                flat.add(path + (k,))

    walk(params)
    left = flat - used
    if left:
        raise KeyError(f"flax leaves with no module weight: "
                       f"{sorted('/'.join(p) for p in left)}")
    want = {k: p for k, p in module.named_parameters() if p.requires_grad}
    missing = set(want) - set(out)
    if missing:
        raise KeyError(f"no flax leaf for module weight {sorted(missing)}")
    with torch.no_grad():
        for name, v in out.items():
            p = want[name]
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{name}: flax shape {v.shape} != module "
                                 f"shape {tuple(p.shape)}")
            p.copy_(torch.tensor(v))


def to_flax_params(module: BiLSTMTagger) -> Dict[str, Dict]:
    """The module's weights as a flax BiLSTMTagger `params` numpy tree."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in
          module.state_dict().items()}
    hidden = module.lstm.hidden_size
    tree: Dict[str, Dict] = {
        "Embed_0": {"embedding": sd["embed.weight"].copy()},
        "Dense_0": {"kernel": sd["dense.weight"].T.copy(),
                    "bias": sd["dense.bias"].copy()},
    }
    for cell, sfx in (("OptimizedLSTMCell_0", ""),
                      ("OptimizedLSTMCell_1", "_reverse")):
        wi = sd[f"lstm.weight_ih_l0{sfx}"].T
        wh = sd[f"lstm.weight_hh_l0{sfx}"].T
        bh = sd[f"lstm.bias_hh_l0{sfx}"]  # bias_ih stays 0
        tree[cell] = {}
        for k, g in enumerate(_GATES):
            cut = slice(k * hidden, (k + 1) * hidden)
            tree[cell][f"i{g}"] = {"kernel": wi[:, cut].copy()}
            tree[cell][f"h{g}"] = {"kernel": wh[:, cut].copy(),
                                   "bias": bh[cut].copy()}
    return tree


def _initial_state(module: BiLSTMTagger, seed: int) -> None:
    """The fit's initial weights, from a torch.Generator seeded with
    `seed`, initialised like flax's modules: embeddings normal with
    variance 1/features, input and dense kernels LeCun-normal, recurrent
    kernels orthogonal a gate, biases 0."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        e = module.embed.weight
        e.copy_(torch.randn(e.shape, generator=gen) / e.shape[1] ** 0.5)
        d = module.dense.weight
        d.copy_(torch.randn(d.shape, generator=gen) / d.shape[1] ** 0.5)
        module.dense.bias.zero_()
        hidden = module.lstm.hidden_size
        for sfx in ("", "_reverse"):
            wi = getattr(module.lstm, f"weight_ih_l0{sfx}")
            wi.copy_(torch.randn(wi.shape, generator=gen) / wi.shape[1] ** 0.5)
            wh = getattr(module.lstm, f"weight_hh_l0{sfx}")
            for k in range(4):
                q, r = torch.linalg.qr(torch.randn(hidden, hidden,
                                                   generator=gen))
                wh[k * hidden:(k + 1) * hidden] = q * torch.sign(
                    torch.diagonal(r))[None, :]
            getattr(module.lstm, f"bias_hh_l0{sfx}").zero_()
            getattr(module.lstm, f"bias_ih_l0{sfx}").zero_()


def _loss_fn(module: BiLSTMTagger, ids: torch.Tensor, lens: torch.Tensor,
             tags: torch.Tensor) -> torch.Tensor:
    from .linear import _full_f32

    with _full_f32():
        logits = module(ids, lens)
    mask = (torch.arange(ids.shape[1], device=ids.device)[None, :]
            < lens[:, None]).float()
    ll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tags.reshape(-1).long(),
                         reduction="none").reshape(tags.shape)
    return torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


@register_stage
class SequenceTagger(Estimator):
    """Token-level tagger: fit on (tokens, tags) list columns.

    Vocabulary is built from the training tokens; OOV -> index 1, pad -> 0.
    """

    tokens_col = Param("column of token lists", default="tokens")
    tags_col = Param("column of tag lists", default="tags")
    prediction_col = Param("predicted tag list column", default="prediction")
    embed_dim = Param("embedding dim", default=64,
                      converter=TypeConverters.to_int)
    hidden = Param("LSTM hidden size", default=128,
                   converter=TypeConverters.to_int)
    epochs = Param("training epochs", default=10,
                   converter=TypeConverters.to_int)
    learning_rate = Param("adam lr", default=1e-3,
                          converter=TypeConverters.to_float)
    buckets = Param("padding buckets", default=list(DEFAULT_BUCKETS),
                    converter=TypeConverters.to_list_int)
    seed = Param("init seed", default=0, converter=TypeConverters.to_int)
    device = Param(DEVICE_DOC, default=None)

    def _fit(self, table: Table) -> "SequenceTaggerModel":
        if len(table) == 0:
            raise ValueError("SequenceTagger.fit: no training rows")
        dev = resolve_device(self.device)
        token_lists = [list(map(str, t)) for t in table[self.tokens_col]]
        tag_lists = [list(map(str, t)) for t in table[self.tags_col]]
        for i, (toks, tags) in enumerate(zip(token_lists, tag_lists)):
            if len(toks) != len(tags):
                raise ValueError(
                    f"row {i}: {len(toks)} tokens but {len(tags)} tags — "
                    "token/tag lists must align"
                )
        vocab = {"<pad>": 0, "<unk>": 1}
        for toks in token_lists:
            for t in toks:
                vocab.setdefault(t, len(vocab))
        tag_vocab: Dict[str, int] = {}
        for tags in tag_lists:
            for t in tags:
                tag_vocab.setdefault(t, len(tag_vocab))

        id_seqs = [
            np.array([vocab.get(t, 1) for t in toks], np.int32)
            for toks in token_lists
        ]
        tag_seqs = [
            np.array([tag_vocab[t] for t in tags], np.int32)
            for tags in tag_lists
        ]
        buckets = tuple(self.buckets)
        config = {"vocab_size": len(vocab), "num_tags": len(tag_vocab),
                  "embed_dim": int(self.embed_dim), "hidden": int(self.hidden)}
        module = BiLSTMTagger(**config)
        _initial_state(module, int(self.seed))
        module = module.to(dev).train()
        opt = torch.optim.Adam([p for p in module.parameters()
                                if p.requires_grad],
                               lr=float(self.learning_rate),
                               betas=(0.9, 0.999), eps=1e-8)

        bucketed_ids = pad_to_buckets(id_seqs, buckets)
        batches = []
        for b, (ids, lens, rows) in bucketed_ids.items():
            tags = pad_to_buckets([tag_seqs[r] for r in rows], (b,))[b][0]
            batches.append(tuple(torch.as_tensor(a, device=dev)
                                 for a in (ids, lens, tags)))
        # no per-step host sync: the losses stay on the device
        for _ in range(int(self.epochs)):
            for ids, lens, tags in batches:
                opt.zero_grad(set_to_none=True)
                _loss_fn(module, ids, lens, tags).backward()
                opt.step()
        return SequenceTaggerModel(
            model_params=to_flax_params(module),
            vocab=vocab, tag_vocab=tag_vocab, module_config=config,
            tokens_col=self.tokens_col, prediction_col=self.prediction_col,
            buckets=list(buckets), device=self.device,
        )


@register_stage
class SequenceTaggerModel(Model):
    tokens_col = Param("column of token lists", default="tokens")
    prediction_col = Param("predicted tag list column", default="prediction")
    buckets = Param("padding buckets", default=list(DEFAULT_BUCKETS),
                    converter=TypeConverters.to_list_int)
    model_params = ComplexParam("flax-layout params tree (numpy)")
    vocab = ComplexParam("token vocabulary")
    tag_vocab = ComplexParam("tag vocabulary")
    module_config = ComplexParam("BiLSTMTagger config")
    device = Param(DEVICE_DOC, default=None)

    def _transform(self, table: Table) -> Table:
        from .linear import _full_f32

        vocab = self.vocab
        inv_tags = {v: k for k, v in self.tag_vocab.items()}
        token_lists = [list(map(str, t)) for t in table[self.tokens_col]]
        id_seqs = [
            np.array([vocab.get(t, 1) for t in toks], np.int32)
            for toks in token_lists
        ]
        out = np.empty(len(table), dtype=object)
        if not id_seqs:
            return table.with_column(self.prediction_col, out)
        dev = resolve_device(self.device)
        module = BiLSTMTagger(**self.module_config)
        from_flax_params(self.model_params, module)
        module = module.to(dev).eval()
        for b, (ids, lens, rows) in pad_to_buckets(
            id_seqs, tuple(self.buckets)
        ).items():
            with torch.no_grad(), _full_f32():
                logits = module(torch.as_tensor(ids, device=dev),
                                torch.as_tensor(lens, device=dev))
            preds = torch.argmax(logits, dim=-1).cpu().numpy()
            for j, r in enumerate(rows):
                n = int(lens[j])
                out[r] = [inv_tags[int(p)] for p in preds[j, :n]]
        return table.with_column(self.prediction_col, out)
