"""The port's slot and paged decode and its ContinuousBatcher
(mmlspark_tpu_torch.models.transformer / serving.batcher) held against
the JAX package's on the same weights (bridged with `from_flax_variables`)
and the same numpy inputs.

1. `decode_step` with per-slot positions, over dense and paged caches,
   2-tuple and int8 4-tuple, one token and a block of three, learned
   positions, RoPE and GQA: logits and written caches against the JAX
   `decode_step`, whose one-token paged branch reaches the Pallas kernels
   B7/B8 in interpret mode (`_single_tpu` forced, MHA, D = 64, page 8;
   its GQA branch takes the XLA gather).  Tolerance 2e-4 abs and rel, the
   JAX suite's own for kernel against dense logits; int8 codes must be
   equal.
2. The JAX suite's batcher oracles (tests/test_continuous_batching.py) on
   the CPU: every stream equals JAX `generate`'s tokens for its prompt
   (int8 too), whatever its co-tenants; pages return to the free list;
   admission defers, rejects, shares prefixes and releases them; eos,
   stop, deadlines and load shedding settle every stream.
"""
import functools
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import transformer as T
from mmlspark_tpu.models.generation import generate as j_generate
from mmlspark_tpu_torch.core import telemetry
from mmlspark_tpu_torch.models.bundle import TorchBundle, from_flax_variables
from mmlspark_tpu_torch.serving.batcher import ContinuousBatcher
from mmlspark_tpu_torch.utils.fault_tolerance import Overloaded

from torch_port_util import random_transformer_params

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
WAIT = 120  # seconds a stream may go without a token before a test fails

# ---- 1. decode_step --------------------------------------------------------

V, E, H, L = 64, 128, 2, 32          # D = 64
NP, PAGE, MP, NB = 9, 8, 4, 3
TABLE = np.array([[1, 2, 0, 0], [3, 0, 0, 0], [4, 5, 6, 7]], np.int32)
VARIANTS = {"learned": {}, "rope": {"pos_emb": "rope"},
            "gqa": {"num_kv_heads": 1}, "int8": {}}


@functools.lru_cache(maxsize=None)
def _lm(variant):
    kw = dict(vocab_size=V, embed_dim=E, num_layers=1, num_heads=H,
              max_len=L, **VARIANTS[variant])
    model = T.transformer_lm(dtype=jnp.float32, **kw)
    variables = random_transformer_params(
        model, jnp.zeros((1, 4), jnp.int32), seed=3)
    bundle = from_flax_variables("transformer_lm", variables, kw,
                                 dtype="float32")
    return model, variables, bundle.module(torch.device("cpu"))


def _caches(variant, paged, seed):
    """One layer's cache with garbage everywhere: pools [NP, PAGE, hkv,
    D] (paged) or dense slots [NB, L, hkv, D]; int8 codes + scales for
    the int8 variant."""
    rng = np.random.default_rng(seed)
    hkv = 1 if variant == "gqa" else H
    lead = (NP, PAGE) if paged else (NB, L)
    if variant == "int8":
        kq, vq = (rng.integers(-127, 128, lead + (hkv, E // H)).astype(
            np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.001, 0.05, lead + (hkv,)).astype(np.float32)
                  for _ in range(2))
        return (kq, ks, vq, vs)
    return tuple(rng.normal(size=lead + (hkv, E // H)).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("variant,paged,s", [
    ("learned", True, 1), ("learned", True, 3), ("learned", False, 1),
    ("learned", False, 3), ("rope", True, 1), ("rope", False, 3),
    ("gqa", True, 1), ("gqa", True, 3), ("int8", True, 1), ("int8", True, 3),
    ("int8", False, 1)])
def test_slot_decode_step_matches_jax(variant, paged, s, monkeypatch):
    monkeypatch.setattr(T, "_single_tpu", lambda: True)
    model, variables, module = _lm(variant)
    rng = np.random.default_rng(10 + s)
    tok = rng.integers(0, V, (NB, s)).astype(np.int32)
    # mid-page, pos 0, and the cache's last positions; with RoPE (no
    # position table) the block's last position runs past the cache: a
    # paged write goes to the trash page, a dense one is dropped
    over = variant == "rope" and s > 1
    pos = np.array([11, 0, L - 2 if over else L - s], np.int32)
    cache = _caches(variant, paged, seed=20 + s)
    table = TABLE if paged else None
    j_logits, j_cache = model.apply(
        variables, jnp.asarray(tok), (tuple(map(jnp.asarray, cache)),),
        jnp.asarray(pos), None if table is None else jnp.asarray(table),
        method=model.decode_step)
    p_cache = tuple(torch.from_numpy(c.copy()) for c in cache)
    with torch.inference_mode():
        p_logits, (p_out,) = module.decode_step(
            torch.from_numpy(tok), (p_cache,), torch.from_numpy(pos),
            None if table is None else torch.from_numpy(table))
    j_logits = np.asarray(j_logits)
    assert np.isfinite(j_logits).all()
    np.testing.assert_allclose(p_logits.numpy(), j_logits, **TOL)
    for i, (got, ref) in enumerate(zip(p_out, j_cache[0])):
        got, ref = got.numpy(), np.asarray(ref)
        if paged:  # the trash page holds whatever the dead writes left
            got, ref = got[1:], ref[1:]
        if got.dtype == np.int8:
            # codes of rows that quantize the same f32 values: equal, up to
            # a last-bit difference in the K/V projection at a .5 tie
            assert (np.abs(got.astype(int) - ref) > 1).sum() == 0, i
            assert (got != ref).mean() < 1e-3, i
        else:
            np.testing.assert_allclose(got, ref, err_msg=f"cache {i}", **TOL)


# ---- 2. the batcher's oracles ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _serving_lm():
    kw = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=2,
              max_len=48)
    model = T.transformer_lm(dtype=jnp.float32, **kw)
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 4), jnp.int32), train=False)
    variables = {"params": jax.tree.map(np.asarray, variables["params"])}
    bundle = from_flax_variables("transformer_lm", variables, kw,
                                 dtype="float32")
    return model, variables, bundle


@functools.lru_cache(maxsize=None)
def _reference(prompt, n, kv_cache_dtype=None):
    model, variables, _bundle = _serving_lm()
    out = j_generate(model, variables, jnp.asarray(prompt)[None],
                     max_new_tokens=n, kv_cache_dtype=kv_cache_dtype)
    return np.asarray(out)[0, len(prompt):].tolist()


def _ref(prompt, n, kv_cache_dtype=None):
    return _reference(tuple(prompt), n, kv_cache_dtype)


def _batcher(**kw):
    return ContinuousBatcher(_serving_lm()[2], device="cpu", **kw)


# every reference is generate(prompt, N) at one of a few prompt lengths
# (3, 5, 10, 12, 24, 41), so the JAX side compiles few programs
N = 6
PROMPTS = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 2, 7], [3, 5, 8, 9, 1],
           [2, 7, 1], [9, 9, 1, 4, 4]]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(paged=True, page_size=8, num_pages=13),
    dict(kv_cache_dtype="int8"),
    dict(paged=True, page_size=8, kv_cache_dtype="int8")],
    ids=["dense", "paged", "dense_int8", "paged_int8"])
def test_streams_match_jax_generate_under_co_tenancy(kw):
    batcher = _batcher(max_slots=2, **kw).start()
    try:
        streams = [batcher.submit(p, max_new_tokens=N) for p in PROMPTS]
        got = [s.tokens(timeout=WAIT) for s in streams]
    finally:
        batcher.stop()
    kvd = kw.get("kv_cache_dtype")
    for p, toks in zip(PROMPTS, got):
        assert toks == _ref(p, N, kvd), (p, toks)
    if batcher.paged:  # every page went back to the free list
        assert sorted(batcher._free) == list(range(1, batcher._np))
        assert batcher._avail == batcher._np - 1


def test_slot_reuse_and_eos():
    ref = _ref([4, 4, 4], N)
    eos = ref[2]  # pretend the 3rd greedy token is eos
    batcher = _batcher(max_slots=1).start()
    try:
        # strictly serial through ONE slot: finish -> admit -> finish
        a = batcher.submit([7, 7, 1], max_new_tokens=N).tokens(timeout=WAIT)
        b = batcher.submit([9, 1, 2, 5, 5], max_new_tokens=N).tokens(
            timeout=WAIT)
        e = batcher.submit([4, 4, 4], max_new_tokens=N,
                           eos_id=eos).tokens(timeout=WAIT)
    finally:
        batcher.stop()
    assert a == _ref([7, 7, 1], N) and b == _ref([9, 1, 2, 5, 5], N)
    assert e == ref[:3] and e[-1] == eos  # stops AT the eos token


def test_stop_unblocks_consumers_and_submit_validates():
    batcher = _batcher(max_slots=1)
    with pytest.raises(ValueError, match="empty"):
        batcher.submit([])
    with pytest.raises(ValueError, match="max_len"):
        batcher.submit([1] * 40, max_new_tokens=20)
    batcher.start()
    s1 = batcher.submit([1, 2], max_new_tokens=40)   # hogs the slot a while
    s2 = batcher.submit([3, 4], max_new_tokens=40)   # queued behind it
    batcher.stop()
    # both streams terminate (possibly truncated), never hang
    assert isinstance(s1.tokens(timeout=WAIT), list)
    assert isinstance(s2.tokens(timeout=WAIT), list)
    with pytest.raises(RuntimeError, match="stopped"):
        batcher.submit([1, 2], max_new_tokens=2)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        _batcher(kv_cache_dtype="int4")
    # a draft must be a TransformerLM bundle sharing the vocabulary
    with pytest.raises(TypeError, match="TorchBundle"):
        _batcher(draft_model=object())
    with pytest.raises(ValueError, match="vocabulary"):
        _batcher(draft_model=TorchBundle(
            "transformer_lm", dict(vocab_size=V + 1, embed_dim=16,
                                   num_layers=1, num_heads=2, max_len=16),
            dtype="float32"))


def test_paged_admission_defers_until_pages_free():
    """A pool too small for two worst-case tenants serializes them (strict
    FIFO reservation) instead of corrupting pages; both streams exact."""
    # worst case per request: ceil((5 + 6) / 8) = 2 pages; 3 usable pages
    batcher = _batcher(max_slots=2, paged=True, page_size=8,
                       num_pages=4).start()
    try:
        a = batcher.submit(PROMPTS[1], max_new_tokens=N)
        b = batcher.submit(PROMPTS[3], max_new_tokens=N)
        got_a, got_b = a.tokens(timeout=WAIT), b.tokens(timeout=WAIT)
    finally:
        batcher.stop()
    assert got_a == _ref(PROMPTS[1], N) and got_b == _ref(PROMPTS[3], N)
    rejecting = _batcher(max_slots=1, paged=True, page_size=8, num_pages=3)
    with pytest.raises(ValueError, match="pages"):
        rejecting.submit([1] * 20, max_new_tokens=20)  # needs 5 > 2 pages


def test_prefix_streams_exact_pages_shared_and_immutable():
    """Requests submitted as (prefix handle, suffix) emit generate(prefix +
    suffix)'s tokens over the handle's shared pages; a second wave over
    the same prefix stays exact (no stray write into shared pages); a
    page-aligned prefix with an empty suffix takes its first token from
    the stored logits; a suffix whose bucket pads past max_len writes its
    pad rows to the trash page."""
    batcher = _batcher(max_slots=2, paged=True, page_size=8).start()
    prefix = [7, 3, 1, 4, 1, 5, 9, 2, 6, 5]             # 1 shared page
    suffixes = [[8, 9], [], [2, 2]]
    try:
        h = batcher.register_prefix(prefix)
        assert batcher._prefixes[h]["shared"] == 1
        shared_pages = list(batcher._prefixes[h]["pages"])
        waves = []
        for _ in range(2):
            streams = [batcher.submit(sfx, max_new_tokens=N, prefix=h)
                       for sfx in suffixes]
            plain = batcher.submit(PROMPTS[0], max_new_tokens=N)
            waves.append(([s.tokens(timeout=WAIT) for s in streams],
                          plain.tokens(timeout=WAIT)))
        assert list(batcher._prefixes[h]["pages"]) == shared_pages
        p3 = list(range(1, 25))                          # 3 pages exactly
        h3 = batcher.register_prefix(p3)
        assert batcher._prefixes[h3]["shared"] == 3
        toks_aligned = batcher.submit([], max_new_tokens=N,
                                      prefix=h3).tokens(timeout=WAIT)
        long_sfx = [3] * 17                              # rest 17 -> 32
        toks_long = batcher.submit(long_sfx, max_new_tokens=N,
                                   prefix=h3).tokens(timeout=WAIT)
    finally:
        batcher.stop()
    for got, got_plain in waves:
        for sfx, toks in zip(suffixes, got):
            assert toks == _ref(prefix + sfx, N), (sfx, toks)
        assert got_plain == _ref(PROMPTS[0], N)
    assert toks_aligned == _ref(p3, N)
    assert toks_long == _ref(p3 + long_sfx, N)


def test_paged_int8_prefix_streams_match_jax_batcher():
    """With int8 pools a shared-prefix request's suffix attends over the
    QUANTIZED prefix rows (generate()'s one prefill attends over them
    unquantized), so the reference is the JAX package's own
    ContinuousBatcher, paged int8 over the same prefix, on the same
    weights: every stream equal, token for token."""
    from mmlspark_tpu.serving.batcher import ContinuousBatcher as JBatcher

    model, variables, _bundle = _serving_lm()
    prefix = [7, 3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]  # 2 pages
    suffixes = [[8, 9], [], [2, 2, 6, 4, 3]]
    kw = dict(max_slots=2, paged=True, page_size=8, kv_cache_dtype="int8")
    got = {}
    for name, batcher in (("port", _batcher(**kw)),
                          ("jax", JBatcher(model, variables, **kw))):
        batcher.start()
        try:
            h = batcher.register_prefix(prefix)
            streams = [batcher.submit(sfx, max_new_tokens=N, prefix=h)
                       for sfx in suffixes]
            streams.append(batcher.submit(PROMPTS[1], max_new_tokens=N))
            got[name] = [s.tokens() for s in streams]
        finally:
            batcher.stop()
    assert got["port"] == got["jax"]
    assert got["port"][-1] == _ref(PROMPTS[1], N, "int8")


def test_prefix_release_and_accounting():
    batcher = _batcher(max_slots=1, paged=True, page_size=8).start()
    try:
        h = batcher.register_prefix(list(range(1, 10)))   # 1 shared page
        busy = batcher.submit([3] * 5, max_new_tokens=25, prefix=h)
        # refs count from submit, so the refusal is deterministic
        with pytest.raises(ValueError, match="active"):
            batcher.release_prefix(h)
        busy.tokens(timeout=WAIT)
        toks = batcher.submit([3], max_new_tokens=N,
                              prefix=h).tokens(timeout=WAIT)
        assert toks == _ref(list(range(1, 10)) + [3], N)
        # the stream's end is enqueued before the loop frees its pages
        for _ in range(250):
            if len(batcher._free) == batcher._np - 2:
                break
            time.sleep(0.02)
        assert len(batcher._free) == batcher._np - 2      # prefix page held
        batcher.release_prefix(h)
        assert sorted(batcher._free) == list(range(1, batcher._np))
        assert batcher._avail == batcher._np - 1
    finally:
        batcher.stop()


def test_prefix_ceiling_counts_all_prefixes_and_late_prefix_fails_head():
    # 5 usable pages; a registered prefix holds 1
    batcher = _batcher(max_slots=1, paged=True, page_size=8, num_pages=6)
    h = batcher.register_prefix(list(range(1, 10)))
    with pytest.raises(ValueError, match="can ever free"):
        batcher.submit([1] * 20, max_new_tokens=20)  # 5 own > 4 achievable
    batcher.release_prefix(h)
    # passes now (5 == 5) and waits; a prefix registered after it shrinks
    # the achievable budget: the head must fail, not wedge the FIFO
    doomed = batcher.submit([1] * 20, max_new_tokens=20)
    batcher.register_prefix(list(range(1, 10)))
    batcher.start()
    try:
        with pytest.raises(RuntimeError, match="can ever free"):
            doomed.tokens(timeout=WAIT)
        behind = batcher.submit(PROMPTS[2], max_new_tokens=N).tokens(
            timeout=WAIT)
    finally:
        batcher.stop()
    assert behind == _ref(PROMPTS[2], N)


def test_deadlines_and_shedding_settle_streams():
    telemetry.reset_counters("batcher.")
    batcher = _batcher(max_slots=1, max_pending=2)
    first = batcher.submit(PROMPTS[4], max_new_tokens=N)
    late = batcher.submit([3, 4], max_new_tokens=4,
                          deadline=time.monotonic() - 1.0)
    with pytest.raises(Overloaded):
        batcher.submit([5], max_new_tokens=2)
    batcher.start()
    try:
        assert first.tokens(timeout=WAIT) == _ref(PROMPTS[4], N)
        with pytest.raises(TimeoutError, match="deadline"):
            late.tokens(timeout=WAIT)
    finally:
        batcher.stop()
    assert telemetry.counters("batcher.") == {"batcher.shed": 1,
                                              "batcher.deadline_expired": 1}


def test_a_dead_loop_fails_its_streams():
    batcher = _batcher(max_slots=2)

    def broken(*_a, **_k):
        raise RuntimeError("injected decode failure")

    batcher._step = broken
    streams = [batcher.submit([1, 2], max_new_tokens=4),
               batcher.submit([3], max_new_tokens=4)]
    caught = []
    hook = threading.excepthook
    threading.excepthook = lambda args: caught.append(args.exc_value)
    try:
        batcher.start()
        for s in streams:
            with pytest.raises(RuntimeError, match="loop died"):
                s.tokens(timeout=WAIT)
        batcher._thread.join(timeout=WAIT)
        assert not batcher._thread.is_alive()
        with pytest.raises(RuntimeError, match="loop died"):
            batcher.submit([1], max_new_tokens=2)
    finally:
        threading.excepthook = hook
        batcher.stop()
    assert caught and "injected" in str(caught[0])


def test_stream_text_emits_whole_words():
    class Words:
        """Ids are subwords; an even id ends a word."""
        eos_id = None

        def encode(self, text, append_eos=False):
            return [len(w) % 64 for w in text.split()]

        def decode(self, ids):
            return "".join(f"w{i}" for i in ids)

        def is_word_end(self, tok):
            return tok % 2 == 0

    batcher = _batcher(max_slots=2).start()
    try:
        pieces = list(batcher.stream_text(Words(), "hello there world", N))
    finally:
        batcher.stop()
    ids = _ref([5, 5, 5], N)
    words, cur = [], []
    for t in ids:
        cur.append(t)
        if t % 2 == 0:
            words.append(cur)
            cur = []
    if cur:
        words.append(cur)
    assert pieces == [Words().decode(w) + " " for w in words]


def test_put_group_packs_one_copy_and_retries_then_raises():
    """The tick's upload: several arrays in ONE transfer, unpacked with
    their dtypes and shapes; copied before the call returns (the batcher
    mutates its vectors right after); a failed copy retries through the
    transfer policy, then raises — never per-array puts."""
    from mmlspark_tpu_torch.io.feed import DeviceFeed, FEED_TELEMETRY
    from mmlspark_tpu_torch.utils.faults import FAULTS, FaultPlan, InjectedFault

    feed = DeviceFeed("cpu", transfer_retries=3)
    tok = np.arange(8, dtype=np.int32)[:, None]
    pos = np.arange(8, dtype=np.int32) * 3
    table = np.arange(8 * 16, dtype=np.int32).reshape(8, 16)
    scale = np.linspace(0, 1, 5).astype(np.float32)
    want = [a.copy() for a in (tok, pos, table, scale)]
    before = FEED_TELEMETRY.snapshot()
    outs = feed.put_group([tok, pos, table, scale])
    pos += 1
    table.fill(0)
    delta = FEED_TELEMETRY.delta(before)
    assert delta["transfer_calls"] == 1 and delta["chunks_fed"] == 4
    # four arrays, each at a 128-byte-aligned offset: 4 x 128 + 512 bytes
    assert delta["bytes_moved"] == 3 * 128 + 512
    for got, ref in zip(outs, want):
        assert got.dtype == torch.from_numpy(ref).dtype
        np.testing.assert_array_equal(got.numpy(), ref)
    telemetry.reset_counters("feed.")
    with FAULTS.arm(FaultPlan().on("feed.device_put", nth=[0, 1])):
        outs = feed.put_group([tok, pos])
    np.testing.assert_array_equal(outs[1].numpy(), pos)
    assert telemetry.counters("feed.") == {"feed.transfer_retry": 2}
    with FAULTS.arm(FaultPlan().on("feed.device_put", nth=[0, 1, 2])):
        with pytest.raises(InjectedFault):
            feed.put_group([tok, pos])
