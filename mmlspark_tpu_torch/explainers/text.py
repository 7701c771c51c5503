"""Text LIME / KernelSHAP via token masking.

Reference: explainers/TextLIME.scala, TextSHAP.scala — whitespace tokens are
the interpretable units; samples drop tokens and rebuild the string.

A copy of the JAX package's `explainers/text.py` for this package.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.params import Param, TypeConverters
from ..core.registry import register_stage
from ..core.schema import Table
from .base import KernelSHAPBase, LIMEBase, pad_ragged_states

__all__ = ["TextLIME", "TextSHAP"]


class _TextSamplerMixin:
    input_col = Param("text column", default="text")
    tokens_col = Param("output column holding the token list", default="tokens")

    def _tokens(self, table: Table) -> List[List[str]]:
        return [str(v).split() for v in table[self.input_col]]

    def _emit(self, table: Table, states: List[np.ndarray],
              tokens: List[List[str]]) -> Table:
        n = len(table)
        s = states[0].shape[0]
        texts = np.empty(n * s, dtype=object)
        for i in range(n):
            toks = tokens[i]
            for j in range(s):
                keep = states[i][j]
                texts[i * s + j] = " ".join(
                    t for t, k in zip(toks, keep) if k > 0.5
                )
        out = table.take(np.repeat(np.arange(n), s))
        return out.with_column(self.input_col, texts)

    def _attach_tokens(self, result: Table, tokens: List[List[str]]) -> Table:
        col = np.empty(len(tokens), dtype=object)
        for i, t in enumerate(tokens):
            col[i] = t
        return result.with_column(self.tokens_col, col)


@register_stage
class TextLIME(LIMEBase, _TextSamplerMixin):
    """LIME over tokens: bernoulli keep-masks (reference TextLIME.scala)."""

    sampling_fraction = Param("P(keep token)", default=0.7,
                              converter=TypeConverters.to_float)

    def _build_samples(self, table: Table):
        rng = np.random.default_rng(int(self.seed))
        tokens = self._tokens(table)
        self._token_lists = tokens
        self._true_dims = [max(len(t), 1) for t in tokens]
        s = int(self.num_samples)
        p = float(self.sampling_fraction)
        states = []
        for toks in tokens:
            k = max(len(toks), 1)
            st = (rng.random((s, k)) < p).astype(np.float32)
            st[0] = 1.0
            states.append(st)
        return self._emit(table, states, tokens), pad_ragged_states(states)

    def _transform(self, table: Table) -> Table:
        result = super()._transform(table)
        return self._attach_tokens(result, self._token_lists)


@register_stage
class TextSHAP(KernelSHAPBase, _TextSamplerMixin):
    """KernelSHAP over tokens (reference TextSHAP.scala)."""

    def _build_samples(self, table: Table):
        rng = np.random.default_rng(int(self.seed))
        tokens = self._tokens(table)
        self._token_lists = tokens
        self._true_dims = [max(len(t), 1) for t in tokens]
        states = [self._coalitions(k, rng) for k in self._true_dims]
        return self._emit(table, states, tokens), pad_ragged_states(states)

    def _transform(self, table: Table) -> Table:
        result = super()._transform(table)
        return self._attach_tokens(result, self._token_lists)
