"""The port's BiLSTM tagger (mmlspark_tpu_torch.models.bilstm) held against
the JAX package's flax tagger on the same parameters and rows, on the CPU.

The flax params tree maps onto `nn.LSTM` gate for gate (i, f, g, o):
input kernels `ii/if/ig/io` -> `weight_ih`, recurrent kernels and biases
`hi/hf/hg/ho` -> `weight_hh` / `bias_hh`, `bias_ih` held at 0.  Every
leaf is random in the parity tests, biases included.

Tolerances.  Logits (f32) within 1e-5 of their largest magnitude at every
position inside a row's length (observed about 1e-7; outside it the
frameworks differ by design and the reference masks them).  A fit from
the JAX fit's own initial params (the same `module.init` call), 3
epochs of Adam: every param within 1e-4 of its tensor's largest
magnitude (Adam's early steps are lr·g/|g|, so rounding in a tiny
gradient moves an entry by up to lr; observed 1.2e-5) and the predicted
tags equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.models import bilstm as JB

from mmlspark_tpu_torch import Table as PTable
from mmlspark_tpu_torch.models import bilstm as PB

torch.set_num_threads(2)

CPU = {"device": "cpu"}


def _random_params(vocab, tags, embed, hidden, seed=4):
    module = JB.BiLSTMTagger(vocab_size=vocab, num_tags=tags,
                             embed_dim=embed, hidden=hidden)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32),
        jnp.ones((1,), jnp.int32)))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        scale = 0.1 if path[-1].key == "bias" else 1.0 / np.sqrt(s.shape[0])
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return module, jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(
        fill, shapes))


def test_bucket_helpers_equal_the_reference():
    rng = np.random.default_rng(1)
    seqs = [rng.integers(2, 50, int(rng.integers(0, 300))).astype(np.int32)
            for _ in range(40)]
    for n in (0, 1, 16, 17, 256, 257, 999):
        assert PB.bucket_length(n) == JB.bucket_length(n)
    for buckets in (PB.DEFAULT_BUCKETS, (8, 40)):
        got, want = PB.pad_to_buckets(seqs, buckets), \
            JB.pad_to_buckets(seqs, buckets)
        assert list(got) == list(want)  # the dict order the fit follows
        for b in want:
            for g, w in zip(got[b], want[b]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_logits_on_ragged_rows_match_flax():
    vocab, tags, embed, hidden = 30, 5, 6, 7
    jmod, params = _random_params(vocab, tags, embed, hidden)
    rng = np.random.default_rng(2)
    lens = np.array([16, 9, 1, 0, 13, 4], np.int32)
    ids = np.zeros((len(lens), 16), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(2, vocab, n)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids),
                                 jnp.asarray(lens)))
    module = PB.BiLSTMTagger(vocab, tags, embed, hidden)
    PB.from_flax_params(params, module)
    with torch.no_grad():
        got = module(torch.from_numpy(ids), torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=1e-5 * scale,
                                   rtol=0)


def test_the_bridge_round_trips_and_refuses_stray_leaves():
    jmod, params = _random_params(12, 3, 4, 5)
    module = PB.BiLSTMTagger(12, 3, 4, 5)
    PB.from_flax_params(params, module)
    back = PB.to_flax_params(module)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    stray = dict(params, Extra_0={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="Extra_0"):
        PB.from_flax_params(stray, PB.BiLSTMTagger(12, 3, 4, 5))
    short = {k: v for k, v in params.items() if k != "Dense_0"}
    with pytest.raises(KeyError):
        PB.from_flax_params(short, PB.BiLSTMTagger(12, 3, 4, 5))
    assert not module.lstm.bias_ih_l0.requires_grad
    assert float(module.lstm.bias_ih_l0.abs().max()) == 0.0


def _corpus(n=40, seed=5):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(25)]
    toks = np.empty(n, object)
    tags = np.empty(n, object)
    for i in range(n):
        k = int(rng.integers(1, 22)) if i % 11 else 0
        t = [str(w) for w in rng.choice(words, k)]
        toks[i] = t
        tags[i] = ["N" if int(w[1:]) % 3 else "V" for w in t]
    return toks, tags


@functools.lru_cache(maxsize=None)
def _fits():
    toks, tags = _corpus()
    kw = dict(embed_dim=8, hidden=6, epochs=3, learning_rate=1e-2,
              buckets=[8, 16, 32], seed=3)
    jm = JB.SequenceTagger(**kw).fit(JTable({"tokens": toks, "tags": tags}))

    def jax_init(module, seed):
        cfg = dict(vocab_size=module.embed.num_embeddings,
                   num_tags=module.dense.out_features,
                   embed_dim=module.embed.embedding_dim,
                   hidden=module.lstm.hidden_size)
        first_b = JB.bucket_length(len(toks[0]), tuple(kw["buckets"]))
        params = JB.BiLSTMTagger(**cfg).init(
            jax.random.PRNGKey(int(seed)), jnp.zeros((1, first_b), jnp.int32),
            jnp.ones((1,), jnp.int32))["params"]
        PB.from_flax_params(jax.tree.map(np.asarray, params), module)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(PB, "_initial_state", jax_init)
        pm = PB.SequenceTagger(**kw, **CPU).fit(
            PTable({"tokens": toks, "tags": tags}))
    finally:
        mp.undo()
    return jm, pm, toks, tags


def test_a_fit_from_the_jax_init_matches_the_jax_fit():
    jm, pm, toks, _ = _fits()
    assert pm.vocab == jm.vocab and pm.tag_vocab == jm.tag_vocab
    assert pm.module_config == jm.module_config
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jm.model_params)))
    got = dict(jax.tree_util.tree_leaves_with_path(pm.model_params))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[path], w, atol=1e-4 * scale, rtol=0,
                                   err_msg=str(path))
    pj = jm.transform(JTable({"tokens": toks}))["prediction"]
    pp = pm.transform(PTable({"tokens": toks}))["prediction"]
    assert [list(x) for x in pp] == [list(x) for x in pj]


def test_a_jax_fitted_model_transforms_on_the_port():
    jm, _, toks, _ = _fits()
    pm = PB.SequenceTaggerModel(
        model_params=jax.tree.map(np.asarray, jm.model_params),
        vocab=dict(jm.vocab), tag_vocab=dict(jm.tag_vocab),
        module_config=dict(jm.module_config), buckets=list(jm.buckets),
        **CPU)
    rows = np.empty(len(toks) + 2, object)
    for i, t in enumerate(toks):
        rows[i] = t
    rows[-2] = []
    rows[-1] = ["unseen-word", "w3"]
    pj = jm.transform(JTable({"tokens": rows}))["prediction"]
    pp = pm.transform(PTable({"tokens": rows}))["prediction"]
    assert [list(x) for x in pp] == [list(x) for x in pj]
    assert list(pp[-2]) == []


def test_errors_follow_the_reference():
    with pytest.raises(ValueError, match="no training rows"):
        PB.SequenceTagger(**CPU).fit(PTable({"tokens": np.empty(0, object),
                                             "tags": np.empty(0, object)}))
    toks, tags = np.empty(1, object), np.empty(1, object)
    toks[0], tags[0] = ["a", "b"], ["N"]
    with pytest.raises(ValueError, match="must align"):
        PB.SequenceTagger(**CPU).fit(PTable({"tokens": toks, "tags": tags}))
