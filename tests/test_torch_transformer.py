"""The port's TransformerLM, KV-cached decode and greedy `generate`
(mmlspark_tpu_torch.models.transformer / generation) held against the JAX
package's on the same weights (every flax leaf random, bridged with
`from_flax_variables`) and the same numpy tokens.

The JAX side takes its single-chip attention branch, the Pallas flash
kernel in interpret mode, by forcing the dispatch predicate
(`monkeypatch.setattr(T, "_single_tpu", lambda: True)`), as the JAX
package's own tests do (test_attention_kernels.py:174-189); the port on
the CPU runs the kernel's plain version.

Tolerance: 2e-4 abs and rel on every tap in f32, the JAX suite's own for
kernel-vs-dense logits (test_attention_kernels.py:189): both sides are
f32, summed in another order (observed gaps ~1e-6).  Greedy tokens must
be identical.
"""
import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.models import generation as JG
from mmlspark_tpu.models import transformer as T
from mmlspark_tpu.models.bundle import FlaxBundle
from mmlspark_tpu.models.tpu_model import TPUModel
from mmlspark_tpu.parallel.ring_attention import full_attention as j_full
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.models import generation as G
from mmlspark_tpu_torch.models import transformer as PT
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.parallel.ring_attention import full_attention
from mmlspark_tpu_torch.serving.batcher import ContinuousBatcher

from torch_port_util import random_transformer_params, to_dicts

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
V, E, H, S, MAX_LEN = 64, 128, 2, 128, 160

VARIANTS = {
    "learned": dict(num_layers=2),
    "rope": dict(num_layers=2, pos_emb="rope"),
    "gqa": dict(num_layers=1, num_kv_heads=1),
}


def _kwargs(variant):
    return dict(vocab_size=V, embed_dim=E, num_heads=H, max_len=MAX_LEN,
                **VARIANTS[variant])


@functools.lru_cache(maxsize=None)
def _case(variant):
    kw = _kwargs(variant)
    model = T.transformer_lm(dtype=jnp.float32, **kw)
    tokens = np.random.default_rng(1).integers(0, V, (2, S)).astype(np.int32)
    variables = random_transformer_params(model, jnp.asarray(tokens), seed=2)
    bundle = from_flax_variables("transformer_lm", variables, kw,
                                 input_shape=(S,), dtype="float32")
    return variant, model, variables, bundle, tokens


@pytest.fixture(params=sorted(VARIANTS))
def case(request):
    return _case(request.param)


@pytest.fixture
def kernel_path(monkeypatch):
    monkeypatch.setattr(T, "_single_tpu", lambda: True)


def _port_taps(bundle, tokens):
    with torch.inference_mode():
        taps = bundle.apply(bundle.module(torch.device("cpu")),
                            torch.from_numpy(tokens))
    return {k: v.numpy() for k, v in taps.items()}


def test_every_tap_matches_jax(case, kernel_path):
    _name, model, variables, bundle, tokens = case
    _logits, ref = model.apply(variables, jnp.asarray(tokens))
    got = _port_taps(bundle, tokens)
    assert bundle.layer_names == T.TransformerLM.layer_names
    assert sorted(got) == sorted(ref) == sorted(bundle.layer_names)
    for k in bundle.layer_names:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), err_msg=k,
                                   **TOL)


def test_decode_steps_match_jax(case, kernel_path):
    _name, model, variables, bundle, tokens = case
    # the whole S-token row is the prompt, so the JAX prefill reuses the
    # interpret-mode kernel the tap test compiled at this shape
    prompt, new = tokens, tokens[:, :4]
    j_logits, j_cache = JG._prefill_cache(model, variables,
                                          jnp.asarray(prompt))
    module = bundle.module(torch.device("cpu"))
    with torch.inference_mode():
        p_logits, p_cache = G._prefill_cache(module, torch.from_numpy(prompt))
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(j_logits),
                                   **TOL)
        for i in range(new.shape[1]):
            tok = new[:, i:i + 1]
            j_lg, j_cache = model.apply(variables, jnp.asarray(tok), j_cache,
                                        S + i, method=model.decode_step)
            p_lg, p_cache = module.decode_step(torch.from_numpy(tok),
                                               p_cache, S + i)
            np.testing.assert_allclose(p_lg.numpy(), np.asarray(j_lg),
                                       err_msg=f"step {i}", **TOL)


def test_greedy_generate_tokens_match_jax(kernel_path):
    _name, model, variables, bundle, tokens = _case("learned")
    ref = np.asarray(JG.generate(model, variables, jnp.asarray(tokens), 8))
    got = G.generate(bundle, tokens, 8, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, S + 8)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generate_sampling_and_eos_semantics():
    _name, _model, _variables, bundle, tokens = _case("learned")
    prompt = tokens[:, :16]
    gen = torch.Generator().manual_seed(0)
    a = G.generate(bundle, prompt, 6, temperature=0.8, top_k=5,
                   generator=gen, device="cpu")
    b = G.generate(bundle, prompt, 6, temperature=0.8, top_k=5,
                   generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(a, b)
    greedy = G.generate(bundle, prompt, 6, device="cpu")
    eos = int(greedy[0, 16])
    frozen = G.generate(bundle, prompt, 6, eos_id=eos, device="cpu")
    assert (frozen[0, 16:] == eos).all()
    with pytest.raises(ValueError):
        G.generate(bundle, prompt, 6, temperature=1.0, device="cpu")
    with pytest.raises(ValueError):
        G.generate(bundle, prompt, MAX_LEN, device="cpu")


def test_filter_logits_matches_jax():
    lg = np.random.default_rng(4).standard_normal((3, 40)).astype(np.float32)
    for top_k, top_p in ((5, None), (None, 0.7), (8, 0.5), (None, None)):
        ref = np.asarray(JG._filter_logits(jnp.asarray(lg), top_k, top_p))
        got = G._filter_logits(torch.from_numpy(lg), top_k, top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        np.testing.assert_allclose(got[~np.isinf(got)], ref[~np.isinf(ref)])


def test_torch_model_scores_tokens_like_tpu_model(kernel_path):
    _name, model, variables, bundle, tokens = _case("learned")
    rows = np.random.default_rng(6).integers(0, V, (5, S)).astype(np.int32)
    kw = _kwargs("learned")
    jb = FlaxBundle("transformer_lm", dict(kw, dtype=jnp.float32),
                    variables=variables, input_shape=(S,))
    ref = TPUModel(bundle=jb, input_col="tokens", output_col="emb",
                   fetch_node="pool", batch_size=3, feed_dtype="int32"
                   ).transform(JTable({"tokens": rows}))["emb"]
    got = TorchModel(bundle=bundle, input_col="tokens", output_col="emb",
                     fetch_node="pool", batch_size=3, feed_dtype="int32",
                     device="cpu").transform(Table({"tokens": rows}))["emb"]
    assert bundle.input_dtype == "int32"
    assert got.shape == ref.shape == (5, E)
    np.testing.assert_allclose(got, ref, **TOL)


def test_bridge_raises_on_leftover_and_missing_leaves(case):
    name, _model, variables, _bundle, _tokens = case
    kw = _kwargs(name)
    params = to_dicts(variables["params"])
    extra = {"params": dict(params, ln_f=dict(params["ln_f"],
                                              extra=np.zeros(3, np.float32)))}
    with pytest.raises(KeyError):
        from_flax_variables("transformer_lm", extra, kw)
    missing = {"params": {k: v for k, v in params.items() if k != "block0"}}
    with pytest.raises(KeyError):
        from_flax_variables("transformer_lm", missing, kw)
    with pytest.raises(KeyError):
        from_flax_variables("transformer_lm",
                            {"params": params, "kvcache": {}}, kw)
    with pytest.raises(ValueError):
        from_flax_variables("transformer_lm", variables,
                            dict(kw, vocab_size=V + 1))


def test_unported_options_raise():
    """The options that raised NotImplementedError until they were ported
    build and run: MoE blocks (`moe_experts`) and a speculative batcher's
    draft (tests/test_torch_moe.py and tests/test_torch_speculative.py
    hold them against the JAX package)."""
    moe = PT.transformer_lm(vocab_size=8, embed_dim=16, num_layers=1,
                            num_heads=2, max_len=8, moe_experts=2)
    with torch.inference_mode():
        lg, _taps = moe(torch.zeros(1, 3, dtype=torch.int32))
    assert lg.shape == (1, 3, 8) and hasattr(moe.blocks[0], "moe")
    m = PT.transformer_lm(vocab_size=8, embed_dim=16, num_layers=1,
                          num_heads=2, max_len=8)
    batcher = ContinuousBatcher(_bundle_of(m), draft_model=_bundle_of(m),
                                gamma=2, device="cpu").start()
    try:
        toks = batcher.submit([1, 2], max_new_tokens=3).tokens(timeout=60)
    finally:
        batcher.stop()
    ref = G.generate(_bundle_of(m), np.array([[1, 2]], np.int32), 3,
                     device="cpu")
    assert toks == ref[0, 2:].tolist()
    # slot decode (per-slot pos) and the int8 cache are ported: they run
    cache = G._prefill_cache(m, torch.zeros(1, 2, dtype=torch.int32))[1]
    with torch.inference_mode():
        lg, _ = m.decode_step(torch.zeros(1, 1, dtype=torch.int32), cache,
                              torch.tensor([2]))
    assert lg.shape == (1, 1, 8)
    out = G.generate(_bundle_of(m), np.zeros((1, 2), np.int32), 2,
                     kv_cache_dtype="int8", device="cpu")
    assert out.shape == (1, 4)


def _bundle_of(module):
    from mmlspark_tpu_torch.models.bundle import TorchBundle

    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    return TorchBundle("transformer_lm", dict(
        vocab_size=8, embed_dim=16, num_layers=1, num_heads=2, max_len=8),
        state_dict=sd, dtype="float32")


# ---- the trouble spots, each on its own ---------------------------------

def test_trouble_spot_gelu_is_the_tanh_approximation(monkeypatch):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    flax_gelu = np.asarray(fnn.gelu(jnp.asarray(x)))
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    np.testing.assert_allclose(tanh.numpy(), flax_gelu, atol=1e-6)
    assert np.abs(exact.numpy() - flax_gelu).max() > 1e-4
    seen = []
    real = torch.nn.functional.gelu

    def spy(t, approximate="none"):
        seen.append(approximate)
        return real(t, approximate=approximate)

    monkeypatch.setattr(PT.F, "gelu", spy)
    m = PT.transformer_lm(vocab_size=8, embed_dim=16, num_layers=2,
                          num_heads=2, max_len=8)
    with torch.inference_mode():
        m(torch.zeros(1, 4, dtype=torch.int32))
    assert seen == ["tanh", "tanh"]


def test_trouble_spot_layernorm_epsilon():
    assert fnn.LayerNorm().epsilon == PT.LN_EPS == 1e-6
    m = PT.transformer_lm(vocab_size=8, embed_dim=16, num_layers=2,
                          num_heads=2, max_len=8)
    lns = [x for x in m.modules() if isinstance(x, torch.nn.LayerNorm)]
    assert len(lns) == 5 and all(x.eps == 1e-6 for x in lns)


@pytest.mark.parametrize("variant", ["learned", "gqa"])
def test_trouble_spot_qkv_split_gqa_expansion_and_biases(variant):
    """The q/k/v handed to attention, caught on both sides: the fused
    qkv's equal split along the head axis, GQA's k-first kv split and
    repeat-interleave expansion; and the bias layout."""
    kw = _kwargs(variant)
    model = T.transformer_lm(dtype=jnp.float32, **kw)
    tokens = np.random.default_rng(3).integers(0, V, (1, 16)).astype(np.int32)
    variables = random_transformer_params(model, jnp.asarray(tokens), seed=4)
    caught = {}

    def j_catch(q, k, v):
        caught["jax"] = [np.asarray(x) for x in (q, k, v)]
        return j_full(q, k, v, causal=True)

    def p_catch(q, k, v):
        caught.setdefault("port", [x.numpy().copy() for x in (q, k, v)])
        return full_attention(q, k, v, causal=True)

    T.transformer_lm(dtype=jnp.float32, attn_fn=j_catch,
                     **dict(kw, num_layers=1)).apply(
        {"params": {k: v for k, v in variables["params"].items()
                    if k != "block1"}}, jnp.asarray(tokens))
    bundle = from_flax_variables("transformer_lm", variables,
                                 dict(kw, attn_fn=p_catch),
                                 dtype="float32")
    with torch.inference_mode():
        bundle.apply(bundle.module(torch.device("cpu")),
                     torch.from_numpy(tokens))
    for name, got, ref in zip("qkv", caught["port"], caught["jax"]):
        assert got.shape == ref.shape == (1, 16, H, E // H), name
        np.testing.assert_allclose(got, ref, err_msg=name, **TOL)
    blk = bundle.module(torch.device("cpu")).blocks[0]
    no_bias = [blk.proj] + ([blk.qkv] if variant == "learned"
                            else [blk.q, blk.kv])
    assert all(x.bias is None for x in no_bias)
    assert blk.mlp_in.bias is not None and blk.mlp_out.bias is not None
    kv = np.random.default_rng(5).standard_normal((1, 3, 2, 4)).astype(
        np.float32)
    ref = np.asarray(T._gqa_expand(jnp.asarray(kv), 6))
    got = PT._gqa_expand(torch.from_numpy(kv), 6).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(np.tile(kv, (1, 1, 3, 1)), ref)


def test_trouble_spot_rope_rotates_halves():
    x = np.random.default_rng(7).standard_normal((2, 9, 3, 8)).astype(
        np.float32)
    pos = np.arange(5, 14)
    ref = np.asarray(T._rope(jnp.asarray(x), jnp.asarray(pos)))
    got = PT._rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_trouble_spot_attention_dtype():
    """In a bf16 model attention takes q/k/v at bf16, returns f32 (scale
    1/sqrt(D), f32 softmax statistics: the attention tests hold those
    against the JAX package), and the block casts it back to bf16 before
    `proj`."""
    seen = {}

    def spy(q, k, v):
        seen["qkv"] = (q.dtype, k.dtype, v.dtype)
        out = full_attention(q, k, v, causal=True)
        seen["out"] = out.dtype
        return out

    m = PT.transformer_lm(vocab_size=8, embed_dim=16, num_layers=1,
                          num_heads=2, max_len=8, attn_fn=spy,
                          dtype="bfloat16")
    def proj_in(_mod, args):
        seen["proj_in"] = args[0].dtype

    m.blocks[0].proj.register_forward_pre_hook(proj_in)
    with torch.inference_mode():
        logits, taps = m(torch.zeros(1, 4, dtype=torch.int32))
    assert seen == {"qkv": (torch.bfloat16,) * 3, "out": torch.float32,
                    "proj_in": torch.bfloat16}
    assert logits.dtype == torch.float32
    assert taps["hidden"].dtype == torch.bfloat16
