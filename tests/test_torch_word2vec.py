"""The port's Word2Vec (mmlspark_tpu_torch.featurize.word2vec) held against
the JAX package's on the CPU (`device="cpu"`).

The two packages draw their initial vectors and negatives from different
generators (a PRNG key against a `torch.Generator`), so the parity tests
hand the port the JAX fit's own: the initial table
`uniform(PRNGKey(seed), (v, d), -0.5, 0.5) / d`, and the negatives of
each step, `choice(sub, v, (b, k), p)` with `key, sub = split(key)` a
step from `PRNGKey(seed)`, the key carried across epochs, drawn inside a
jitted scan as the fit draws them.

Tolerances: the step is the reference's arithmetic in f32 (full-f32
products); the two differ in the order of the batch sums and of the
scatter-add of duplicate rows, a rounding that Adagrad carries from step
to step.  Vectors within 1e-4 of max |v| after 2 epochs (measured at most
3.1e-6 on these corpora), the per-epoch losses within 1e-5 relative;
transform and find_synonyms on the same vectors equal (1e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.featurize import Word2Vec as JW2V

from mmlspark_tpu_torch import Table as PTable
from mmlspark_tpu_torch.featurize import Word2Vec as PW2V
from mmlspark_tpu_torch.featurize import Word2VecModel as PW2VModel
from mmlspark_tpu_torch.featurize import word2vec as PW

torch.set_num_threads(2)

CPU = {"device": "cpu"}
V_TOL = 1e-4


def _topic_docs(n=120, seed=3):
    rng = np.random.default_rng(seed)
    food = ["bread", "cheese", "apple", "soup", "butter"]
    tool = ["hammer", "wrench", "drill", "saw", "pliers"]
    docs = []
    for _ in range(n):
        topic = food if rng.random() < 0.5 else tool
        docs.append(" ".join(rng.choice(topic, size=8)))
    return docs


class _JaxDraws:
    """The JAX fit's initial vectors and negatives, in its order."""

    CHUNK = 32

    def __init__(self, seed):
        self.seed = seed
        self.key = None
        self.buf = []

    def initial(self, v, d, seed, device):
        key = jax.random.PRNGKey(int(seed))
        init = jax.random.uniform(key, (v, d), jnp.float32, -0.5, 0.5) / d
        return torch.tensor(np.asarray(init), device=device)

    def sampler(self, probs, seed, device):
        self.key = jax.random.PRNGKey(int(seed))
        p = jnp.asarray(probs, jnp.float32)
        v = len(probs)

        def draw(b, k):
            if not self.buf:
                self.key, block = _jax_negatives(self.key, p, v, b, k,
                                                 self.CHUNK)
                self.buf = list(np.asarray(block))
            return torch.as_tensor(self.buf.pop(0).astype(np.int64),
                                   device=device)

        return draw


@functools.partial(jax.jit, static_argnames=("v", "b", "k", "n"))
def _jax_negatives(key, p, v, b, k, n):
    def step(key, _):
        key, sub = jax.random.split(key)
        return key, jax.random.choice(sub, v, shape=(b, k), p=p)

    return jax.lax.scan(step, key, None, length=n)


@functools.lru_cache(maxsize=None)
def _fits(kind):
    if kind == "topics":
        docs = _topic_docs()
        kw = dict(vector_size=8, window_size=3, min_count=2, epochs=2,
                  batch_size=64, seed=1)
    elif kind == "small_batch":
        docs = ["a b a b c", "b a b a c", "c a a b"] * 6
        kw = dict(vector_size=4, min_count=2, epochs=2, batch_size=16,
                  negatives=3, learning_rate=0.1, seed=5)
    else:  # one batch narrowed to the pair count
        docs = ["superb. superb book, superb!"] * 3
        kw = dict(min_count=1, epochs=2)
    jm = JW2V(**kw).fit(JTable({"text": docs}))
    draws = _JaxDraws(kw.get("seed", 0))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(PW, "_initial_vectors", draws.initial)
        mp.setattr(PW, "_negative_sampler", draws.sampler)
        pm = PW2V(**kw, **CPU).fit(PTable({"text": docs}))
    finally:
        mp.undo()
    return jm, pm, docs


@pytest.mark.parametrize("kind", ["topics", "small_batch", "narrowed"])
def test_vectors_and_losses_match_jax(kind):
    jm, pm, _ = _fits(kind)
    assert pm.vocabulary == jm.vocabulary
    jv, pv = np.asarray(jm.vectors), np.asarray(pm.vectors)
    assert pv.dtype == np.float32 and pv.shape == jv.shape
    err = float(np.abs(jv - pv).max()) / float(np.abs(jv).max())
    assert err <= V_TOL, err
    np.testing.assert_allclose(pm.training_losses, jm.training_losses,
                               rtol=1e-5)


def test_transform_and_synonyms_equal_on_the_same_vectors():
    jm, _, docs = _fits("topics")
    pm = PW2VModel(vocabulary=list(jm.vocabulary),
                   vectors=np.asarray(jm.vectors))
    toks = np.empty(3, object)
    toks[0] = ["bread", "saw", "zzz-unseen"]
    toks[1] = ["zzz-unseen"]
    toks[2] = "soup, bread and cheese!"
    for rows in (docs[:10], toks):
        fj = np.asarray(jm.transform(JTable({"text": rows}))["features"])
        fp = np.asarray(pm.transform(PTable({"text": rows}))["features"])
        np.testing.assert_allclose(fp, fj, atol=1e-6)
    sj, sp = jm.find_synonyms("bread", 4), pm.find_synonyms("bread", 4)
    assert [w for w, _ in sp] == [w for w, _ in sj]
    np.testing.assert_allclose([s for _, s in sp], [s for _, s in sj],
                               atol=1e-6)
    with pytest.raises(KeyError):
        pm.find_synonyms("zzz-unseen")


def test_a_jax_fitted_model_transforms_on_the_port():
    jm, _, docs = _fits("small_batch")
    pm = PW2VModel(input_col=jm.input_col, output_col=jm.output_col,
                   vocabulary=list(jm.vocabulary),
                   vectors=np.asarray(jm.vectors),
                   training_losses=list(jm.training_losses))
    fj = np.asarray(jm.transform(JTable({"text": docs}))["features"])
    fp = np.asarray(pm.transform(PTable({"text": docs}))["features"])
    np.testing.assert_array_equal(fp, fj)


def test_a_word_twice_in_a_batch_squares_its_summed_gradient():
    """Word 0 is the center of both pairs: Adagrad's accumulator gains the
    square of the summed gradient, as the dense JAX gradient does, not
    the sum of each occurrence's square."""
    gen = torch.Generator().manual_seed(0)
    v, d = 4, 3
    w_in = torch.randn(v, d, generator=gen)
    w_out = torch.randn(v, d, generator=gen)
    g_in, g_out = torch.zeros(v, d), torch.zeros(v, d)
    c = torch.tensor([0, 0])
    o = torch.tensor([1, 2])
    neg = torch.tensor([[3], [3]])
    w_in0 = w_in.clone()
    # autograd's dense gradient of the same loss
    wi = w_in.clone().requires_grad_(True)
    wo = w_out.clone().requires_grad_(True)
    vc = wi[c]
    vc.retain_grad()
    loss = -(torch.mean(torch.nn.functional.logsigmoid(
        torch.sum(vc * wo[o], -1))) + torch.mean(torch.sum(
            torch.nn.functional.logsigmoid(-torch.einsum(
                "bd,bkd->bk", vc, wo[neg])), -1)))
    loss.backward()
    got = PW.sgns_step(w_in, w_out, g_in, g_out, c, o, neg, lr=0.25)
    assert float(got) == pytest.approx(float(loss.detach()), rel=1e-6)
    torch.testing.assert_close(g_in, wi.grad ** 2, rtol=1e-6, atol=0)
    torch.testing.assert_close(g_out, wo.grad ** 2, rtol=1e-6, atol=0)
    # untouched rows stay exactly as they were
    assert torch.equal(w_in[1:], w_in0[1:])
    per_occurrence = (vc.grad ** 2).sum(0)
    assert not torch.allclose(g_in[0], per_occurrence)


def test_the_default_sampler_follows_the_unigram_table():
    probs = np.asarray([0.5, 0.25, 0.15, 0.1], np.float32)
    sample = PW._negative_sampler(probs, 0, torch.device("cpu"))
    draws = torch.cat([sample(1000, 5).reshape(-1) for _ in range(8)])
    assert draws.shape == (40000,) and draws.dtype == torch.int64
    freq = np.bincount(draws.numpy(), minlength=4) / len(draws)
    # 4 standard errors of a 40,000-draw frequency at p = 0.5 is 0.01
    np.testing.assert_allclose(freq, probs, atol=0.01)
    # the generator is carried: a second call draws other ids
    assert not torch.equal(sample(100, 5), sample(100, 5))
    again = PW._negative_sampler(probs, 0, torch.device("cpu"))
    assert torch.equal(again(1000, 5).reshape(-1), draws[:5000])


def test_default_fit_learns_topics():
    docs = _topic_docs(n=200)
    m = PW2V(vector_size=16, window_size=3, min_count=2, epochs=4, seed=1,
             **CPU).fit(PTable({"text": docs}))
    assert m.training_losses[-1] < m.training_losses[0]
    food = {"bread", "cheese", "apple", "soup", "butter"}
    syn = [w for w, _ in m.find_synonyms("bread", 4)]
    assert all(w in food for w in syn), syn


def test_errors_follow_the_reference():
    with pytest.raises(ValueError, match="min_count"):
        PW2V(min_count=5, **CPU).fit(PTable({"text": ["a b c"]}))
    with pytest.raises(ValueError, match="no training pairs"):
        PW2V(min_count=1, **CPU).fit(PTable({"text": ["a", "b"]}))
