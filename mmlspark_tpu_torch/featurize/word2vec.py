"""Word2Vec: skip-gram with negative sampling, trained on the card.

Reference workload parity: the reference's "TextAnalytics - Amazon Book
Reviews with Word2Vec" notebook composes SparkML's `Word2Vec` with
mmlspark's TrainClassifier; a user switching engines needs the embedding
trainer too, so it lives here as a first-class stage with SparkML's
surface (vector_size/window_size/min_count, doc vector = MEAN of word
vectors, `find_synonyms`).

Counterpart of the JAX package's `featurize/word2vec.py`, with its
Params, defaults and output columns.  The vocabulary, the (center,
context) pairs, their permutation (`np.random.default_rng(seed)`), the
unigram^0.75 table and the batch narrowing are the reference's host
code.  Each step runs on the card (`sgns_step`): gathers of the two
[V, D] tables, the log-sigmoid loss, its gradients and Adagrad
`w -= lr g / sqrt(G + 1e-8)` on the dense gradient, so a word that
appears twice in a batch squares its summed gradient, as the JAX step
does.  The products run in full f32 (`models/linear._full_f32`).

Negatives come from a sampler, `sampler(b, k) -> [b, k]` word ids: by
default `torch.multinomial` with replacement over the 0.75-power table,
from one `torch.Generator` on the step's device seeded with `seed` and
carried across epochs (the JAX fit carries its PRNG key the same way;
the two generators give different draws).  The initial input vectors
are uniform in [-0.5, 0.5) / D from a `torch.Generator` seeded with
`seed` (`_initial_vectors`).  `Word2VecModel` is host numpy, as there.

Each estimator has a `device` Param: the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..device import DEVICE_DOC, resolve_device

__all__ = ["Word2Vec", "Word2VecModel", "sgns_step"]


def _tokenize_col(col) -> List[List[str]]:
    # raw strings go through the SAME tokenizer as TextFeaturizer
    # (text.py _tokenize, \W+ split): the two recipes the Amazon-reviews
    # notebooks put side by side must see one vocabulary, not two
    from .text import _tokenize

    docs = []
    for doc in col:
        if isinstance(doc, str):
            docs.append(_tokenize(doc))
        else:
            docs.append([str(t) for t in doc])
    return docs


def _initial_vectors(v: int, d: int, seed: int,
                     device: torch.device) -> torch.Tensor:
    """The input table's initial vectors, uniform in [-0.5, 0.5) / d."""
    gen = torch.Generator().manual_seed(int(seed))
    return ((torch.rand(v, d, generator=gen) - 0.5) / d).to(device)


def _negative_sampler(probs: np.ndarray, seed: int, device: torch.device
                      ) -> Callable[[int, int], torch.Tensor]:
    """sampler(b, k): [b, k] word ids drawn with replacement from `probs`
    by one generator on `device`, carried from call to call."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    p = torch.as_tensor(probs, dtype=torch.float32, device=device)

    def sample(b: int, k: int) -> torch.Tensor:
        return torch.multinomial(p, b * k, replacement=True,
                                 generator=gen).view(b, k)

    return sample


def sgns_step(w_in: torch.Tensor, w_out: torch.Tensor, g_in: torch.Tensor,
              g_out: torch.Tensor, c: torch.Tensor, o: torch.Tensor,
              neg: torch.Tensor, lr: float) -> torch.Tensor:
    """One skip-gram negative-sampling step on (center c [b], context o
    [b], negatives neg [b, k]), updating the two tables and their Adagrad
    accumulators in place; returns the batch's loss (a 0-d tensor).

    The gradient is the dense one of the reference's loss
    -(mean log σ(v_c·u_o) + mean Σ_k log σ(-v_c·u_k)): each row's
    gradient is the sum over the batch's occurrences of its word, and
    Adagrad squares that sum.  An untouched row's gradient is exactly 0,
    so its update is too."""
    from ..models.linear import _full_f32

    wi, wo = w_in.detach().requires_grad_(), w_out.detach().requires_grad_()
    with _full_f32():
        vc = wi[c]                                     # [b, d]
        pos = torch.sum(vc * wo[o], dim=-1)            # [b]
        negs = torch.einsum("bd,bkd->bk", vc, wo[neg])  # [b, k]
        loss = -(torch.mean(F.logsigmoid(pos))
                 + torch.mean(torch.sum(F.logsigmoid(-negs), dim=-1)))
        gi, go = torch.autograd.grad(loss, (wi, wo))
    # adagrad: per-parameter step decay, the classic w2v schedule
    g_in.add_(gi * gi)
    g_out.add_(go * go)
    w_in.sub_(lr * gi / torch.sqrt(g_in + 1e-8))
    w_out.sub_(lr * go / torch.sqrt(g_out + 1e-8))
    return loss.detach()


@register_stage
class Word2Vec(Estimator):
    """Skip-gram negative-sampling embeddings (SparkML Word2Vec surface)."""

    input_col = Param("tokens (list) or raw text column", default="text")
    output_col = Param("document vector column", default="features")
    vector_size = Param("embedding dim", default=32,
                        converter=TypeConverters.to_int)
    window_size = Param("context window radius", default=3,
                        converter=TypeConverters.to_int)
    min_count = Param("drop words rarer than this", default=2,
                      converter=TypeConverters.to_int)
    negatives = Param("negative samples per pair", default=4,
                      converter=TypeConverters.to_int)
    epochs = Param("passes over the pair set", default=3,
                   converter=TypeConverters.to_int)
    learning_rate = Param("adagrad lr", default=0.25,
                          converter=TypeConverters.to_float)
    batch_size = Param("pairs per scanned step", default=1024,
                       converter=TypeConverters.to_int)
    seed = Param("sampling seed", default=0, converter=TypeConverters.to_int)
    device = Param(DEVICE_DOC, default=None)

    def _fit(self, table) -> "Word2VecModel":
        dev = resolve_device(self.device)
        docs = _tokenize_col(table[self.input_col])
        counts: dict = {}
        for toks in docs:
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
        vocab = sorted(w for w, c in counts.items() if c >= self.min_count)
        if not vocab:
            raise ValueError("Word2Vec: no word meets min_count")
        index = {w: i for i, w in enumerate(vocab)}
        v, d = len(vocab), int(self.vector_size)

        # host-side pair extraction (string work); arithmetic on the card
        centers, contexts = [], []
        w = int(self.window_size)
        for toks in docs:
            ids = [index[t] for t in toks if t in index]
            for i, c in enumerate(ids):
                for j in range(max(0, i - w), min(len(ids), i + w + 1)):
                    if j != i:
                        centers.append(c)
                        contexts.append(ids[j])
        if not centers:
            raise ValueError("Word2Vec: no training pairs (docs too short)")
        centers = np.asarray(centers, np.int32)
        contexts = np.asarray(contexts, np.int32)

        # unigram^0.75 negative-sampling table (the word2vec paper's choice)
        freq = np.asarray([counts[wd] for wd in vocab], np.float64) ** 0.75
        neg_probs = (freq / freq.sum()).astype(np.float32)

        # a corpus smaller than one batch still trains: narrow the batch
        # to the pair count instead of feeding reshape a short array
        b = min(int(self.batch_size), len(centers))
        rng = np.random.default_rng(int(self.seed))
        order = rng.permutation(len(centers))
        n_batches = max(1, len(order) // b)
        order = order[: n_batches * b]
        cen = torch.as_tensor(centers[order].reshape(n_batches, b)
                              .astype(np.int64), device=dev)
        ctx = torch.as_tensor(contexts[order].reshape(n_batches, b)
                              .astype(np.int64), device=dev)

        k = int(self.negatives)
        lr = float(self.learning_rate)
        sample = _negative_sampler(neg_probs, int(self.seed), dev)
        w_in = _initial_vectors(v, d, int(self.seed), dev)
        w_out = torch.zeros(v, d, dtype=torch.float32, device=dev)
        g_in = torch.zeros_like(w_out)
        g_out = torch.zeros_like(w_out)

        losses = []
        for _ in range(int(self.epochs)):
            ls = [sgns_step(w_in, w_out, g_in, g_out, cen[s], ctx[s],
                            sample(b, k), lr) for s in range(n_batches)]
            losses.append(float(torch.mean(torch.stack(ls))))
        vectors = w_in.cpu().numpy().astype(np.float32)
        return Word2VecModel(
            input_col=self.input_col, output_col=self.output_col,
            vocabulary=vocab, vectors=vectors,
            training_losses=losses,
        )


@register_stage
class Word2VecModel(Model):
    input_col = Param("tokens (list) or raw text column", default="text")
    output_col = Param("document vector column", default="features")
    vocabulary = ComplexParam("word list, row-aligned with vectors")
    vectors = ComplexParam("embedding matrix [V, D]")
    training_losses = ComplexParam("mean NEG loss per epoch", default=None)

    def _transform(self, table):
        index = {w: i for i, w in enumerate(self.vocabulary)}
        vecs = np.asarray(self.vectors, np.float32)
        d = vecs.shape[1]
        out = np.zeros((len(table), d), np.float32)
        for r, toks in enumerate(_tokenize_col(table[self.input_col])):
            ids = [index[t] for t in toks if t in index]
            if ids:  # SparkML semantics: mean of the word vectors
                out[r] = vecs[ids].mean(axis=0)
        return table.with_column(self.output_col, out)

    def find_synonyms(self, word: str, num: int = 5):
        """Cosine-nearest words, (word, similarity) descending —
        SparkML's findSynonyms."""
        index = {w: i for i, w in enumerate(self.vocabulary)}
        if word not in index:
            raise KeyError(f"{word!r} not in the trained vocabulary")
        vecs = np.asarray(self.vectors, np.float32)
        q = vecs[index[word]]
        sims = (vecs @ q) / (np.linalg.norm(vecs, axis=1)
                             * np.linalg.norm(q) + 1e-9)
        order = [i for i in np.argsort(-sims) if i != index[word]][:num]
        return [(self.vocabulary[i], float(sims[i])) for i in order]
