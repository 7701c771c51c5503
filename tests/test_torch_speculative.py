"""The port's beam search, speculative decoding and speculative continuous
batching (mmlspark_tpu_torch.models.generation `beam_search` /
`speculative_generate`, serving.batcher `ContinuousBatcher(draft_model=)`
and `generate_stream(draft_model=)`) held against the JAX package's on
bridged weights (every flax leaf random) and the same numpy prompts.

Every comparison is exact: beam search's tokens against JAX
`beam_search`'s, speculative decoding's tokens and `rounds` against JAX
`speculative_generate`'s, and every speculative stream against JAX
`generate`'s greedy tokens for its prompt, whatever its co-tenants, dense
and paged, with and without a shared prefix.  Ties in beam search's
top-k go to the lower index, as `jax.lax.top_k` orders them.  The JAX
side runs its default attention on the CPU (dense `full_attention`).
"""
import functools
import http.client
import json
import math
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import generation as JG
from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.ops import quant as JQ
from mmlspark_tpu_torch.models import generation as G
from mmlspark_tpu_torch.models.bundle import from_flax_variables, prequantize
from mmlspark_tpu_torch.serving import read_stream
from mmlspark_tpu_torch.serving.batcher import ContinuousBatcher

from torch_port_util import random_transformer_params

torch.set_num_threads(2)

WAIT = 120  # seconds a stream may go without a token before a test fails
LM = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=2,
          max_len=48)
DRAFT = dict(LM, embed_dim=16, num_layers=1)
PROMPTS = [[3, 1, 4], [1, 5, 9, 2, 6], [5], [3, 5, 8, 9], [2, 7, 1]]
N_NEW = [6, 9, 4, 7, 8]


def _pair(kw, seed, quant=False, zero_head=False):
    model = JT.transformer_lm(dtype=jnp.float32, quant=quant, **kw)
    variables = random_transformer_params(model, jnp.zeros((1, 4), jnp.int32),
                                          seed=seed)
    if zero_head:  # every logit equal: beam search ties everywhere
        variables["params"]["head"]["kernel"] = np.zeros_like(
            variables["params"]["head"]["kernel"])
    bundle = from_flax_variables("transformer_lm", variables,
                                 dict(kw, quant=quant), dtype="float32")
    return model, variables, bundle


@functools.lru_cache(maxsize=None)
def _lm():
    return _pair(LM, seed=1)


@functools.lru_cache(maxsize=None)
def _draft():
    return _pair(DRAFT, seed=5)


@functools.lru_cache(maxsize=None)
def _partial_draft():
    """The target's weights with noise on every leaf: a draft that
    accepts some proposals and rejects others, so rejected tails are
    written and later overwritten."""
    model, variables, _bundle = _lm()
    rng = np.random.default_rng(21)
    noisy = jax.tree.map(
        lambda a: a + 0.5 * np.abs(a).mean() * rng.standard_normal(
            a.shape).astype(np.float32), variables)
    return model, noisy, from_flax_variables("transformer_lm", noisy, LM,
                                             dtype="float32")


@functools.lru_cache(maxsize=None)
def _int8_self_draft():
    """The target prequantized to int8 (tests/test_quant.py:149): JAX's
    'quant' collection and the port's prequantized bundle."""
    model, variables, _bundle = _lm()
    qmodel = JT.transformer_lm(dtype=jnp.float32, quant=True, **LM)
    qvars = JQ.prequantize(qmodel, variables, jnp.zeros((1, 4), jnp.int32))
    qbundle = prequantize(from_flax_variables(
        "transformer_lm", variables, dict(LM, quant=True), dtype="float32"))
    return qmodel, qvars, qbundle


@functools.lru_cache(maxsize=None)
def _reference(prompt, n):
    model, variables, _bundle = _lm()
    out = JG.generate(model, variables, jnp.asarray(prompt)[None],
                      max_new_tokens=n)
    return np.asarray(out)[0, len(prompt):].tolist()


def _prompt(b=2, s=5, seed=0):
    return np.random.default_rng(seed).integers(
        0, LM["vocab_size"], (b, s)).astype(np.int32)


# ---- beam search ------------------------------------------------------------

BEAM_CASES = {
    "one_beam": dict(num_beams=1),
    "three_beams": dict(num_beams=3),
    "eos_and_length_penalty": dict(num_beams=4, length_penalty=0.6, eos_id=7),
    "raw_sum": dict(num_beams=4, length_penalty=0.0, eos_id=3),
    "int8_cache": dict(num_beams=3, kv_cache_dtype="int8"),
}


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_search_matches_jax(case):
    model, variables, bundle = _lm()
    kw = BEAM_CASES[case]
    prompt = _prompt()
    want = np.asarray(JG.beam_search(model, variables, jnp.asarray(prompt),
                                     12, **kw))
    got = G.beam_search(bundle, prompt, 12, device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "one_beam":
        np.testing.assert_array_equal(
            got, G.generate(bundle, prompt, 12, device="cpu").numpy())
    eos = kw.get("eos_id")
    if eos is not None:
        # every row's tail after its first eos is eos
        for row in got[:, prompt.shape[1]:]:
            hit = np.flatnonzero(row == eos)
            if len(hit):
                assert (row[hit[0]:] == eos).all()


def test_beam_search_eos_freezes_finished_beams():
    """An eos the greedy path emits early: the finished hypothesis
    freezes (eos to the end), exactly as in the JAX package."""
    model, variables, bundle = _lm()
    prompt = _prompt(b=1, seed=3)
    eos = int(G.generate(bundle, prompt, 4, device="cpu")[0, -2])
    want = np.asarray(JG.beam_search(model, variables, jnp.asarray(prompt),
                                     10, num_beams=3, eos_id=eos))
    got = G.beam_search(bundle, prompt, 10, num_beams=3, eos_id=eos,
                        device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 5:] == eos).any()


def test_top_k_ties_follow_lax_top_k():
    """`torch.topk` leaves the order of ties open; the stable sort puts
    the lower index first, as `jax.lax.top_k` does."""
    x = np.random.default_rng(4).integers(0, 4, (6, 40)).astype(np.float32)
    x[0] = 1.0                               # one row all ties
    vals, idx = G._top_k_stable(torch.from_numpy(x), 7)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_beam_search_on_equal_logits_matches_jax():
    """A zero head makes every logit equal: each expansion's top-k is all
    ties, and the beams (and their cache rows) must follow lax.top_k's
    order."""
    model, variables, bundle = _pair(LM, seed=6, zero_head=True)
    prompt = _prompt(b=2, seed=7)
    for kw in (dict(num_beams=4), dict(num_beams=3, eos_id=2)):
        want = np.asarray(JG.beam_search(model, variables,
                                         jnp.asarray(prompt), 6, **kw))
        got = G.beam_search(bundle, prompt, 6, device="cpu", **kw).numpy()
        np.testing.assert_array_equal(got, want)


def test_beam_search_validates_inputs():
    bundle = _lm()[2]
    with pytest.raises(ValueError, match="num_beams"):
        G.beam_search(bundle, _prompt(), 4, num_beams=0, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        G.beam_search(bundle, _prompt(), 60, device="cpu")


# ---- speculative decoding -------------------------------------------------

def _jax_draft(kind):
    if kind == "one_layer":
        return _draft()
    if kind == "perfect":
        return _lm()
    if kind == "partial":
        return _partial_draft()
    return _int8_self_draft()


@pytest.mark.parametrize("kind", ["one_layer", "perfect", "partial",
                                  "int8_self"])
def test_speculative_generate_matches_jax_tokens_and_rounds(kind):
    model, variables, bundle = _lm()
    dmodel, dvars, dbundle = _jax_draft(kind)
    prompt, n, g = _prompt(b=1, seed=8), 17, 4
    want, want_rounds = JG.speculative_generate(
        model, variables, dmodel, dvars, jnp.asarray(prompt), n, gamma=g,
        return_stats=True)
    got, rounds = G.speculative_generate(bundle, dbundle, prompt, n, gamma=g,
                                         return_stats=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)
    np.testing.assert_array_equal(
        got.numpy(), G.generate(bundle, prompt, n, device="cpu").numpy())
    if kind == "perfect":
        assert rounds == math.ceil((n - 1) / (g + 1))
    if kind == "partial":
        assert math.ceil((n - 1) / (g + 1)) < rounds < n - 1


def test_speculative_generate_eos_matches_jax():
    model, variables, bundle = _lm()
    dmodel, dvars, dbundle = _draft()
    prompt = _prompt(b=1, seed=9)
    eos = int(G.generate(bundle, prompt, 5, device="cpu")[0, -1])
    want = JG.speculative_generate(model, variables, dmodel, dvars,
                                   jnp.asarray(prompt), 10, gamma=3,
                                   eos_id=eos)
    got = G.speculative_generate(bundle, dbundle, prompt, 10, gamma=3,
                                 eos_id=eos, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_speculative_generate_validates_inputs():
    bundle, dbundle = _lm()[2], _draft()[2]
    with pytest.raises(ValueError, match="batch size 1"):
        G.speculative_generate(bundle, dbundle, _prompt(b=2), 4,
                               device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        G.speculative_generate(bundle, dbundle, _prompt(b=1), 4, gamma=0,
                               device="cpu")
    with pytest.raises(ValueError, match="prompt \\+ new \\+ gamma"):
        G.speculative_generate(bundle, dbundle, _prompt(b=1), 40, gamma=4,
                               device="cpu")
    other = _pair(dict(DRAFT, vocab_size=32), seed=3)[2]
    with pytest.raises(ValueError, match="vocabulary"):
        G.speculative_generate(bundle, other, _prompt(b=1), 4, device="cpu")


# ---- the speculative continuous batcher -----------------------------------

def _batcher(draft=None, **kw):
    draft = _draft()[2] if draft is None else draft
    return ContinuousBatcher(_lm()[2], draft_model=draft, device="cpu", **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("draft", ["one_layer", "partial"])
def test_speculative_batcher_matches_generate(paged, draft):
    """Every co-tenant stream is EXACTLY JAX generate()'s tokens; the
    draft only changes how many target forwards it takes
    (tests/test_continuous_batching.py:430)."""
    batcher = _batcher(_jax_draft(draft)[2], max_slots=2, gamma=3,
                       paged=paged, page_size=8).start()
    try:
        streams = [batcher.submit(p, max_new_tokens=n)
                   for p, n in zip(PROMPTS, N_NEW)]
        got = [st.tokens(timeout=WAIT) for st in streams]
    finally:
        batcher.stop()
    for p, n, toks in zip(PROMPTS, N_NEW, got):
        assert toks == _reference(tuple(p), n), (p, toks)
    if paged:
        assert sorted(batcher._free) == list(range(1, batcher._np))


def test_speculative_batcher_eos_and_paged():
    ref = _reference((4, 4, 4), 10)
    eos = ref[2]
    batcher = _batcher(max_slots=2, paged=True, page_size=8,
                       gamma=3).start()
    try:
        toks = batcher.submit([4, 4, 4], max_new_tokens=10,
                              eos_id=eos).tokens(timeout=WAIT)
        more = [batcher.submit(p, max_new_tokens=6)
                for p in ([1, 2, 3], [9, 8, 7, 6])]
        got_more = [st.tokens(timeout=WAIT) for st in more]
    finally:
        batcher.stop()
    assert toks == ref[:3] and toks[-1] == eos
    for p, g2 in zip([(1, 2, 3), (9, 8, 7, 6)], got_more):
        assert g2 == _reference(p, 6), (p, g2)
    assert sorted(batcher._free) == list(range(1, batcher._np))


def test_speculative_perfect_draft_takes_the_fewest_ticks():
    """The target as its own draft accepts every proposal: 8 tokens are 1
    from the prefill and 7 in ceil(7 / (gamma + 1)) = 2 ticks."""
    batcher = _batcher(_lm()[2], max_slots=1, gamma=3).start()
    ticks = {"n": 0}
    real = batcher._speculative_tick

    def counting(active):
        ticks["n"] += 1
        return real(active)

    batcher._speculative_tick = counting
    try:
        toks = batcher.submit([3, 1, 4], max_new_tokens=8).tokens(timeout=WAIT)
    finally:
        batcher.stop()
    assert toks == _reference((3, 1, 4), 8)
    assert ticks["n"] == math.ceil(7 / 4)


def test_prefix_composes_with_speculation():
    """tests/test_continuous_batching.py:655: shared-prefix requests in a
    paged speculative batcher (the draft prefills their full prompts)."""
    batcher = _batcher(max_slots=2, paged=True, page_size=8,
                       gamma=3).start()
    try:
        prefix = list(range(2, 13))                       # 11 ids
        h = batcher.register_prefix(prefix)
        streams = [batcher.submit([int(i)], max_new_tokens=7, prefix=h)
                   for i in range(3)]
        streams.append(batcher.submit([], max_new_tokens=5, prefix=h))
        got = [s.tokens(timeout=WAIT) for s in streams]
    finally:
        batcher.stop()
    for i, toks in enumerate(got[:3]):
        assert toks == _reference(tuple(prefix + [i]), 7), (i, toks)
    assert got[3] == _reference(tuple(prefix), 5)


def test_speculative_headroom_and_draft_checks():
    """The gamma lookahead in submit, register_prefix and the page
    reservation (tests/test_continuous_batching.py:513, :752); the
    draft's type, vocabulary, gamma and an MoE target's drop-free
    capacity."""
    batcher = _batcher(max_slots=1, gamma=4)
    with pytest.raises(ValueError, match="gamma"):
        # 40 + 5 fits max_len 48 plainly but not with gamma-4 lookahead
        batcher.submit([1] * 40, max_new_tokens=5)
    short = _pair(dict(DRAFT, max_len=16), seed=3)[2]
    paged = _batcher(short, max_slots=1, paged=True, page_size=8, gamma=4)
    with pytest.raises(ValueError, match="draft"):
        paged.register_prefix(list(range(1, 13)))         # 12+1+4 > 16
    paged = _batcher(max_slots=1, paged=True, page_size=8, gamma=4)
    # 5 + 4 + 4 rows: two pages, the lookahead's included
    assert paged._worst_pages(5, 4) == 2
    with pytest.raises(TypeError, match="TorchBundle"):
        ContinuousBatcher(_lm()[2], draft_model=object(), device="cpu")
    other = _pair(dict(DRAFT, vocab_size=32), seed=3)[2]
    with pytest.raises(ValueError, match="vocabulary"):
        ContinuousBatcher(_lm()[2], draft_model=other, device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        _batcher(gamma=0)
    moe = _pair(dict(LM, moe_experts=4, moe_capacity=1.25), seed=4)[2]
    with pytest.raises(ValueError, match="moe_capacity"):
        ContinuousBatcher(moe, draft_model=_draft()[2], device="cpu")


def test_speculative_moe_target_at_drop_free_capacity_is_exact():
    kw = dict(LM, moe_experts=2, moe_capacity=4.0)
    model, variables, bundle = _pair(kw, seed=13)
    batcher = ContinuousBatcher(bundle, draft_model=_draft()[2], max_slots=2,
                                gamma=3, device="cpu").start()
    try:
        got = [st.tokens(timeout=WAIT) for st in
               [batcher.submit(p, max_new_tokens=6) for p in PROMPTS[:3]]]
    finally:
        batcher.stop()
    for p, toks in zip(PROMPTS, got):
        want = np.asarray(JG.generate(model, variables,
                                      jnp.asarray(p)[None], 6))
        assert toks == want[0, len(p):].tolist(), p


def test_finished_slot_parks_at_position_zero():
    """A stream that ends at the lookahead limit leaves its slot at
    position 0, so the next tick's pos + gamma writes stay in the cache
    (the reference's stale-position guard, batcher.py:783)."""
    batcher = _batcher(max_slots=2, gamma=4).start()
    try:
        toks = batcher.submit([1] * 40, max_new_tokens=4).tokens(timeout=WAIT)
        more = batcher.submit([2, 3], max_new_tokens=5).tokens(timeout=WAIT)
    finally:
        batcher.stop()
    assert toks == _reference(tuple([1] * 40), 4)
    assert more == _reference((2, 3), 5)
    assert (batcher._pos == 0).all()


def test_generate_stream_speculative_over_http():
    """The one-call endpoint passes the draft and gamma through to the
    batcher it owns, paged, and every HTTP stream is generate()'s."""
    query = (read_stream().continuous_server(name="spec", path="/spec")
             .parse_request(schema=["prompt"])
             .generate_stream(_lm()[2], max_new_tokens=6, max_slots=2,
                              paged=True, page_size=8,
                              draft_model=_draft()[2], gamma=3, device="cpu")
             .options(batch_timeout_ms=5.0)
             .start())
    results = [None] * 3
    try:
        assert query._batcher.gamma == 3 and query._batcher.paged

        def client(i):
            conn = http.client.HTTPConnection(query.service_info.host,
                                              query.service_info.port,
                                              timeout=WAIT)
            conn.request("POST", "/spec", body=json.dumps(
                {"prompt": PROMPTS[i]}).encode())
            resp = conn.getresponse()
            results[i] = (resp.status, resp.read().decode())
            conn.close()

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
    finally:
        query.stop()
    for i, (status, body) in enumerate(results):
        assert status == 200
        assert [int(t) for t in body.split()] == _reference(
            tuple(PROMPTS[i]), 6)
