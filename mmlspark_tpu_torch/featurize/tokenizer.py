"""Trainable byte-pair-encoding tokenizer as a pipeline stage.

Beyond-reference (the reference's text path stops at hashed bag-of-words,
featurize/text/TextFeaturizer.scala:196-405): the TransformerLM family
needs real token ids, so `BPETokenizer.fit` learns a subword vocabulary
from the corpus column and `BPETokenizerModel.transform` emits int32 id
arrays ready for `models.transformer` / `models.generation` — including
the `eos_id` the decode loop freezes on.

Ids 0/1/2 are reserved: <pad>, <unk>, <eos>.  Training is classic BPE
(most-frequent-pair merging over whitespace words with an end-of-word
marker), encoding applies merges greedily by rank.  All host-side — the
tokenizer feeds the device, it never runs on it.  A copy of the JAX
package's `featurize/tokenizer.py` for this package: the same `Counter`
and dict orders, so the same merges and ids, ties included.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table

__all__ = ["BPETokenizer", "BPETokenizerModel", "pack_sequences"]

PAD_ID, UNK_ID, EOS_ID = 0, 1, 2
_SPECIALS = ["<pad>", "<unk>", "<eos>"]
# end-of-word marker: a private-use codepoint no real corpus contains,
# so decode's marker-to-space rewrite can never collide with input text
_EOW = "\ue000"


def _train_bpe(texts: List[str], vocab_size: int, lowercase: bool
               ) -> Tuple[List[str], List[List[str]]]:
    """Learn (vocab, merges) by most-frequent-pair merging.

    Pair counts update INCREMENTALLY: each merge rewrites only the words
    containing its pair and applies their before/after count deltas —
    O(affected words) per merge instead of a full corpus recount, the
    difference between seconds and minutes on a real corpus."""
    words: Counter = Counter()
    for text in texts:
        if lowercase:
            text = text.lower()
        for w in text.split():
            words[tuple(w) + (_EOW,)] += 1
    symbols = sorted({s for w in words for s in w})
    vocab = list(_SPECIALS) + symbols
    merges: List[List[str]] = []
    words_list = [[list(w), f] for w, f in words.items()]
    pairs: Counter = Counter()
    for w, f in words_list:
        for pair in zip(w, w[1:]):
            pairs[pair] += f
    while len(vocab) < vocab_size:
        pairs = +pairs  # drop zero/negative entries before taking the max
        if not pairs:
            break
        (a, b), top = pairs.most_common(1)[0]
        if top <= 0:
            break
        merged = a + b
        merges.append([a, b])
        vocab.append(merged)
        for item in words_list:
            w = item[0]
            # fast skip: adjacent (a, b) implies a+b appears in the
            # word's joined string (symbols concatenate)
            if merged not in "".join(w):
                continue
            i, out = 0, []
            changed = False
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(merged)
                    i += 2
                    changed = True
                else:
                    out.append(w[i])
                    i += 1
            if changed:
                f = item[1]
                for pair in zip(w, w[1:]):
                    pairs[pair] -= f
                for pair in zip(out, out[1:]):
                    pairs[pair] += f
                item[0] = out
    return vocab, merges


@register_stage
class BPETokenizer(Estimator):
    """Fit a BPE vocabulary on a text column."""

    input_col = Param("text column", default="text")
    output_col = Param("token-id array column", default="tokens")
    vocab_size = Param("target vocabulary size (incl. 3 specials)",
                       default=512, converter=TypeConverters.to_int)
    lowercase = Param("casefold before tokenizing", default=True,
                      converter=TypeConverters.to_bool)
    append_eos = Param("append <eos> to every encoded row", default=False,
                       converter=TypeConverters.to_bool)

    def _fit(self, table: Table) -> "BPETokenizerModel":
        texts = [str(t) for t in table[self.input_col]]
        vocab, merges = _train_bpe(texts, int(self.vocab_size),
                                   bool(self.lowercase))
        return BPETokenizerModel(
            input_col=self.input_col, output_col=self.output_col,
            lowercase=self.lowercase, append_eos=self.append_eos,
            vocab=vocab, merges=merges)

    def transform_schema(self, columns: List[str]) -> List[str]:
        if self.input_col not in columns:
            raise ValueError(f"BPETokenizer: missing column '{self.input_col}'")
        return columns + [self.output_col]


@register_stage
class BPETokenizerModel(Model):
    """Encode text to int32 id arrays (and decode back)."""

    input_col = Param("text column", default="text")
    output_col = Param("token-id array column", default="tokens")
    lowercase = Param("casefold before tokenizing", default=True,
                      converter=TypeConverters.to_bool)
    append_eos = Param("append <eos> to every encoded row", default=False,
                       converter=TypeConverters.to_bool)
    vocab = ComplexParam("id -> token string list")
    merges = ComplexParam("ordered BPE merge pairs")

    # ---- core codec ----------------------------------------------------
    @property
    def eos_id(self) -> int:
        return EOS_ID

    @property
    def _token_to_id(self) -> Dict[str, int]:
        # cache keyed on the list's identity: a replaced vocab (even one
        # of equal length) must rebuild the mapping
        vocab = self.vocab
        key, cache = getattr(self, "_t2i_cache", (None, None))
        if key != id(vocab):
            cache = {t: i for i, t in enumerate(vocab)}
            self._t2i_cache = (id(vocab), cache)
        return cache

    @property
    def _ranks(self) -> Dict[Tuple[str, str], int]:
        merges = self.merges
        key, cache = getattr(self, "_rank_cache", (None, None))
        if key != id(merges):
            cache = {(a, b): r for r, (a, b) in enumerate(merges)}
            self._rank_cache = (id(merges), cache)
        return cache

    def _encode_word(self, word: str) -> List[str]:
        w = list(word) + [_EOW]
        ranks = self._ranks
        while len(w) > 1:
            best, best_rank = None, None
            for i, pair in enumerate(zip(w, w[1:])):
                r = ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            w[best:best + 2] = [w[best] + w[best + 1]]
        return w

    def encode(self, text: str, append_eos: bool = None) -> np.ndarray:
        """Text -> int32 ids.  `append_eos` overrides the stage param per
        call — generation PROMPTS must not end in <eos> even when the
        training corpus rows do."""
        if self.lowercase:
            text = text.lower()
        t2i = self._token_to_id
        ids: List[int] = []
        for word in text.split():
            ids.extend(t2i.get(s, UNK_ID) for s in self._encode_word(word))
        if self.append_eos if append_eos is None else append_eos:
            ids.append(EOS_ID)
        return np.asarray(ids, np.int32)

    def is_word_end(self, tok_id: int) -> bool:
        """True when this token COMPLETES a word (its string carries the
        end-of-word marker).  Streaming emitters buffer ids until this
        fires so subword splits never leak spaces mid-word.  Specials and
        out-of-range ids are NOT word ends: decode() drops them, so
        flushing on one would split the surrounding word — they ride in
        the buffer until a real end-of-word (or stream end) arrives."""
        if not 0 <= tok_id < len(self.vocab):
            return False
        return self.vocab[tok_id].endswith(_EOW)

    def decode(self, ids) -> str:
        """Ids back to text; specials (<pad>/<unk>/<eos>) drop out."""
        toks = [self.vocab[i] for i in np.asarray(ids).tolist()
                if EOS_ID < i < len(self.vocab)]
        text = "".join(toks).replace(_EOW, " ")
        return text.strip()

    # ---- stage surface -------------------------------------------------
    def _transform(self, table: Table) -> Table:
        out = np.empty(table.num_rows, object)
        for i, text in enumerate(table[self.input_col]):
            out[i] = self.encode(str(text))
        return table.with_column(self.output_col, out)

    def transform_schema(self, columns: List[str]) -> List[str]:
        if self.input_col not in columns:
            raise ValueError(
                f"BPETokenizerModel: missing column '{self.input_col}'")
        return columns + [self.output_col]


def pack_sequences(rows, seq_len: int, mode: str = "pad",
                   pad_id: int = PAD_ID) -> np.ndarray:
    """Ragged id arrays -> a dense [N, seq_len] int32 batch for LM training.

    mode="pad": one row per sequence, truncated/padded with `pad_id` (the
    simple fine-tuning shape).  mode="pack": all ids concatenated and
    chunked GPT-style — no padding waste, every position trains; the tail
    remainder pads.  Rows should already carry <eos> (append_eos=True) so
    packed boundaries stay learnable.
    """
    if mode not in ("pad", "pack"):
        raise ValueError(f"mode must be 'pad' or 'pack', got {mode!r}")
    if mode == "pad":
        out = np.full((len(rows), seq_len), pad_id, np.int32)
        for i, r in enumerate(rows):
            r = np.asarray(r, np.int32)
            out[i, :min(seq_len, len(r))] = r[:seq_len]
        return out
    flat = np.concatenate([np.asarray(r, np.int32) for r in rows])
    n = -(-len(flat) // seq_len)
    out = np.full((n * seq_len,), pad_id, np.int32)
    out[:len(flat)] = flat
    return out.reshape(n, seq_len)
