"""Text featurization: tokenize -> stopwords -> ngrams -> TF(-IDF) pipeline.

Reference: core featurize/text/TextFeaturizer.scala:196-405 (pipeline builder
over Tokenizer/StopWordsRemover/NGram/HashingTF|CountVectorizer/IDF),
MultiNGram.scala and PageSplitter.scala.  A copy of the JAX package's
`featurize/text.py` for this package (the same crc32 hash slots).
"""
from __future__ import annotations

import re
from typing import List

from .featurize import _hash_token

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model, Transformer
from ..core.registry import register_stage
from ..core.schema import Table

__all__ = ["TextFeaturizer", "TextFeaturizerModel", "MultiNGram", "PageSplitter"]

# Spark StopWordsRemover's default English list (abbreviated to the common core)
_STOPWORDS = set(
    """a about above after again against all am an and any are as at be because
    been before being below between both but by could did do does doing down
    during each few for from further had has have having he her here hers
    herself him himself his how i if in into is it its itself me more most my
    myself no nor not of off on once only or other our ours ourselves out over
    own same she should so some such than that the their theirs them themselves
    then there these they this those through to too under until up very was we
    were what when where which while who whom why with you your yours yourself
    yourselves""".split()
)


def _tokenize(text: str, pattern: str = r"\W+") -> List[str]:
    return [t for t in re.split(pattern, text.lower()) if t]


def _ngrams(tokens: List[str], n: int) -> List[str]:
    if n <= 1:
        return list(tokens)
    return [" ".join(tokens[i : i + n]) for i in range(len(tokens) - n + 1)]


@register_stage
class TextFeaturizer(Estimator):
    input_col = Param("text column", default="text")
    output_col = Param("feature vector column", default="features")
    use_stop_words_remover = Param("drop stopwords", default=False,
                                   converter=TypeConverters.to_bool)
    use_ngram = Param("add ngrams", default=False, converter=TypeConverters.to_bool)
    n_gram_length = Param("ngram n", default=2, converter=TypeConverters.to_int)
    use_idf = Param("apply IDF weighting", default=True,
                    converter=TypeConverters.to_bool)
    num_features = Param("hash dims", default=1 << 10, converter=TypeConverters.to_int)
    use_tokenizer = Param("split on non-word chars", default=True,
                          converter=TypeConverters.to_bool)
    min_doc_freq = Param("min docs for IDF term", default=1,
                         converter=TypeConverters.to_int)

    def _terms(self, text: str) -> List[str]:
        toks = _tokenize(text) if self.use_tokenizer else text.split()
        if self.use_stop_words_remover:
            toks = [t for t in toks if t not in _STOPWORDS]
        terms = list(toks)
        if self.use_ngram:
            terms += _ngrams(toks, self.n_gram_length)
        return terms

    def _fit(self, table: Table) -> "TextFeaturizerModel":
        dims = self.num_features
        df_counts = np.zeros(dims, dtype=np.int64)
        n_docs = table.num_rows
        for text in table[self.input_col]:
            slots = {_hash_token(t, dims) for t in self._terms(str(text))}
            for s in slots:
                df_counts[s] += 1
        if self.use_idf:
            idf = np.log((n_docs + 1.0) / (df_counts + 1.0))
            idf[df_counts < self.min_doc_freq] = 0.0
        else:
            idf = np.ones(dims)
        return TextFeaturizerModel(
            input_col=self.input_col,
            output_col=self.output_col,
            idf=idf.astype(np.float64),
            config={
                "use_stop_words_remover": self.use_stop_words_remover,
                "use_ngram": self.use_ngram,
                "n_gram_length": self.n_gram_length,
                "use_tokenizer": self.use_tokenizer,
                "num_features": dims,
            },
        )


@register_stage
class TextFeaturizerModel(Model):
    input_col = Param("text column", default="text")
    output_col = Param("feature vector column", default="features")
    idf = ComplexParam("idf weights per hash slot")
    config = ComplexParam("tokenization config")

    def _terms(self, text: str) -> List[str]:
        cfg = self.config
        toks = _tokenize(text) if cfg["use_tokenizer"] else text.split()
        if cfg["use_stop_words_remover"]:
            toks = [t for t in toks if t not in _STOPWORDS]
        terms = list(toks)
        if cfg["use_ngram"]:
            terms += _ngrams(toks, cfg["n_gram_length"])
        return terms

    def _transform(self, table: Table) -> Table:
        dims = self.config["num_features"]
        idf = np.asarray(self.idf)
        out = np.zeros((table.num_rows, dims), dtype=np.float32)
        for i, text in enumerate(table[self.input_col]):
            for t in self._terms(str(text)):
                out[i, _hash_token(t, dims)] += 1.0
        out *= idf[None, :].astype(np.float32)
        return table.with_column(self.output_col, out)


@register_stage
class MultiNGram(Transformer):
    """Concatenate ngram sets for a range of n (featurize/text/MultiNGram.scala)."""

    input_col = Param("token array column", default="tokens")
    output_col = Param("ngram array column", default="ngrams")
    lengths = Param("list of n values", default=[1, 2, 3])

    def _transform(self, table: Table) -> Table:
        out = []
        for toks in table[self.input_col]:
            toks = list(toks)
            grams: List[str] = []
            for n in self.lengths:
                grams += _ngrams(toks, int(n))
            out.append(grams)
        return table.with_column(self.output_col, out)


@register_stage
class PageSplitter(Transformer):
    """Split text into pages of bounded length on whitespace boundaries
    (featurize/text/PageSplitter.scala)."""

    input_col = Param("text column", default="text")
    output_col = Param("pages column", default="pages")
    maximum_page_length = Param("max chars per page", default=5000,
                                converter=TypeConverters.to_int)
    minimum_page_length = Param("min chars before breaking", default=4500,
                                converter=TypeConverters.to_int)

    def _transform(self, table: Table) -> Table:
        out = []
        for text in table[self.input_col]:
            text = str(text)
            pages, cur = [], ""
            for piece in re.split(r"(\s+)", text):
                if len(cur) + len(piece) > self.maximum_page_length and len(cur) >= self.minimum_page_length:
                    pages.append(cur)
                    cur = ""
                while len(cur) + len(piece) > self.maximum_page_length:
                    take = self.maximum_page_length - len(cur)
                    pages.append(cur + piece[:take])
                    piece, cur = piece[take:], ""
                cur += piece
            if cur:
                pages.append(cur)
            out.append(pages)
        return table.with_column(self.output_col, out)
