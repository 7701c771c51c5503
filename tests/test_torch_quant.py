"""The port's int8 weight inference (mmlspark_tpu_torch.ops.quant,
`quant=True` in TransformerLM and the ViT) held against the JAX
package's `ops/quant.py` on the same f32 inputs and bridged weights.

Exact where the arithmetic is the same: `quantize_weight`,
`int8_matmul` and `int8_dense` give the JAX package's int8 weights,
scales and f32 outputs bit for bit, and the prequantized path gives the
on-the-fly path's output bit for bit (the JAX suite's
test_quant.py:78-92).

Whole models are held within ONE ROUNDING LEVEL of an activation: the
float ops between the int8 layers (LayerNorm, attention, GELU) are
summed in another order on the two sides (gaps ~1e-6 in f32), and an
activation that lies that close to a rounding boundary of x / xs can
round to the neighbouring int8 level on one side only.  One level moves
an output of that layer by xs * ws[n] * |wq[n, k]| <= xs * max|w[n]|,
with xs = max|x| / 127: about 1/127 of the largest activation times the
largest weight, which the next layers carry on.  The bound used is
`LEVEL_RTOL` = 2/127 of the largest logit / feature magnitude (two
levels' worth), and almost every element must still agree to 2e-4, the
f32 tolerance of the unquantized parity tests.  Greedy tokens must be
identical.
"""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import generation as JG
from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.models import vit as JV
from mmlspark_tpu.ops import quant as JQ
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.io.image import array_to_image_row
from mmlspark_tpu_torch.models import generation as G
from mmlspark_tpu_torch.models import transformer as PT
from mmlspark_tpu_torch.models import vit as PV
from mmlspark_tpu_torch.models.bundle import (TorchBundle, from_flax_variables,
                                              prequantize)
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.ops import quant as Q
from mmlspark_tpu_torch.serving.batcher import ContinuousBatcher

from torch_port_util import random_transformer_params

torch.set_num_threads(2)

LEVEL_RTOL = 2.0 / 127.0
F32_TOL = 2e-4
LM = dict(vocab_size=64, embed_dim=64, num_layers=2, num_heads=2,
          max_len=64)
HW = 32


# ---------------------------------------------------------------------------
# the ops: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,bias", [((8, 64), True), ((3, 5, 48), False),
                                        ((1, 24), True)])
def test_quantize_weight_and_int8_matmul_match_jax_exactly(shape, bias):
    rng = np.random.default_rng(len(shape) + shape[-1])
    k, n = shape[-1], 40
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    jwq, jws = JQ.quantize_weight(jnp.asarray(w))
    wq, ws = Q.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert wq.dtype == torch.int8 and ws.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy().T, np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.from_numpy(b)
    ref = np.asarray(JQ.int8_matmul(jnp.asarray(x), jwq, jws, jb))
    got = Q.int8_matmul(torch.from_numpy(x), wq, ws, tb)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_dense = np.asarray(JQ.int8_dense(jnp.asarray(x), jnp.asarray(w), jb))
    got_dense = Q.int8_dense(torch.from_numpy(x),
                             torch.from_numpy(np.ascontiguousarray(w.T)), tb)
    np.testing.assert_array_equal(got_dense.numpy(), ref_dense)


def test_int8_dense_zero_input_is_zero():
    out = Q.int8_dense(torch.zeros(4, 16), torch.zeros(8, 16))
    assert torch.count_nonzero(out) == 0


def test_quant_linear_stays_f32_under_a_bf16_cast_and_counts_gemms():
    layer = Q.QuantLinear(16, 8).to(torch.bfloat16)
    assert layer.weight.dtype == torch.float32
    assert layer.bias.dtype == torch.float32
    Q.prequantize(layer)
    layer = layer.to(dtype=torch.bfloat16)
    assert layer.wq.dtype == torch.int8 and layer.ws.dtype == torch.float32
    Q.INT8_GEMMS = 0
    y = layer(torch.ones(2, 3, 16, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 3, 8)
    assert Q.INT8_GEMMS == 1
    # the quant class is a drop-in: nn.Linear weights load unchanged
    assert Q.dense_cls(True) is Q.QuantLinear
    assert Q.dense_cls(False) is torch.nn.Linear


def test_a_fresh_module_loads_a_prequantized_state_dict_strictly():
    m = PT.transformer_lm(quant=True, **LM)
    Q.prequantize(m)
    sd = m.state_dict()
    assert sd["blocks.0.qkv.wq"].dtype == torch.int8
    assert sd["head.ws"].shape == (LM["vocab_size"],)
    fresh = PT.transformer_lm(quant=True, **LM)
    fresh.load_state_dict(sd)  # strict
    assert torch.equal(fresh.blocks[1].mlp_out.wq, m.blocks[1].mlp_out.wq)


def test_prequantize_without_quant_layers_is_descriptive():
    with pytest.raises(ValueError, match="no QuantLinear"):
        Q.prequantize(PT.transformer_lm(**LM))


def test_unported_quant_neighbours_still_raise():
    """int8 with MoE blocks, which raised NotImplementedError until the
    MoE was ported, builds and runs as the JAX package's: qkv, proj and
    the head are int8, the router and the experts stay float, and the
    LM's logits and greedy tokens are the JAX package's within one
    rounding level (the module docstring's bound)."""
    kw = dict(LM, quant=True, moe_experts=2, moe_capacity=4.0)
    tokens = np.random.default_rng(11).integers(
        0, LM["vocab_size"], (2, 12)).astype(np.int32)
    model = JT.transformer_lm(dtype=jnp.float32, **kw)
    variables = random_transformer_params(model, jnp.asarray(tokens), seed=12)
    bundle = from_flax_variables("transformer_lm", variables, kw,
                                 input_shape=(12,), dtype="float32")
    block = bundle.module(torch.device("cpu")).blocks[0]
    assert isinstance(block.qkv, Q.QuantLinear)
    assert not isinstance(block.moe.router, Q.QuantLinear)
    Q.INT8_GEMMS = 0
    got = _port_taps(bundle, tokens)
    assert Q.INT8_GEMMS == 2 * LM["num_layers"] + 1  # qkv, proj; the head
    _lg, ref = model.apply(variables, jnp.asarray(tokens))
    _within_one_level(got["logits"], ref["logits"], "logits")
    want = np.asarray(JG.generate(model, variables, jnp.asarray(tokens), 6))
    np.testing.assert_array_equal(
        G.generate(bundle, tokens, 6, device="cpu").numpy(), want)
    vit = PV.VisionTransformer(quant=True, moe_experts=2, image_size=HW,
                               patch_size=8, embed_dim=64, num_layers=1,
                               num_heads=2)
    assert isinstance(vit.blocks[0].qkv, Q.QuantLinear)
    with torch.no_grad():
        logits, _taps = vit(torch.zeros(1, HW, HW, 3))
    assert logits.shape == (1, 1000) and torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# whole models on bridged weights
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _vit_case():
    x = np.random.default_rng(5).integers(0, 255, (3, HW, HW, 3)).astype(
        np.float32)
    model = JV.vit_tiny(num_classes=6, dtype=jnp.float32, quant=True)
    variables = random_transformer_params(model, jnp.asarray(x[:1]), seed=6)
    bundle = from_flax_variables(
        "vit_tiny", variables, {"num_classes": 6, "quant": True},
        input_shape=(HW, HW, 3), dtype="float32")
    return model, variables, bundle, x


@functools.lru_cache(maxsize=None)
def _lm_case():
    tokens = np.random.default_rng(7).integers(
        0, LM["vocab_size"], (2, 12)).astype(np.int32)
    model = JT.transformer_lm(dtype=jnp.float32, quant=True, **LM)
    variables = random_transformer_params(model, jnp.asarray(tokens), seed=8)
    bundle = from_flax_variables("transformer_lm", variables,
                                 dict(LM, quant=True), input_shape=(12,),
                                 dtype="float32")
    return model, variables, bundle, tokens


def _port_taps(bundle, batch):
    with torch.inference_mode():
        taps = bundle.apply(bundle.module(torch.device("cpu")),
                            torch.from_numpy(batch))
    return {k: v.numpy() for k, v in taps.items()}


def _within_one_level(got, ref, name):
    """Equal to the f32 tolerance but for a few elements an activation
    rounding flip moved, which stay within LEVEL_RTOL of the largest
    magnitude (the module docstring's reasoning)."""
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    diff = np.abs(got - ref)
    assert diff.max() <= LEVEL_RTOL * scale, (name, diff.max(), scale)
    off = diff > F32_TOL + F32_TOL * np.abs(ref)
    assert off.mean() <= 0.05, (name, off.mean())


def test_vit_quant_taps_match_jax_within_one_level():
    model, variables, bundle, x = _vit_case()
    assert isinstance(bundle.module(torch.device("cpu")).blocks[0].qkv,
                      Q.QuantLinear)
    # the head stays a plain linear layer, as in the JAX package
    assert type(bundle.module(torch.device("cpu")).head) is torch.nn.Linear
    _lg, ref = model.apply(variables, jnp.asarray(x))
    got = _port_taps(bundle, x)
    for k in ("logits", "pool"):
        _within_one_level(got[k], ref[k], k)


def test_vit_quant_keeps_the_reference_bound_against_f32():
    """The JAX suite's own bound (test_quant.py:43-57): int8 logits stay
    correlated > 0.98 with the unquantized model's on the same weights."""
    _model, variables, bundle, x = _vit_case()
    plain = from_flax_variables("vit_tiny", variables, {"num_classes": 6},
                                input_shape=(HW, HW, 3), dtype="float32")
    q, f = _port_taps(bundle, x)["logits"], _port_taps(plain, x)["logits"]
    assert np.corrcoef(q.ravel(), f.ravel())[0, 1] > 0.98


def test_lm_quant_logits_and_greedy_tokens_match_jax():
    model, variables, bundle, tokens = _lm_case()
    Q.INT8_GEMMS = 0
    got = _port_taps(bundle, tokens)
    # qkv, proj, mlp_in, mlp_out a layer, and the head
    assert Q.INT8_GEMMS == 4 * LM["num_layers"] + 1
    _lg, ref = model.apply(variables, jnp.asarray(tokens))
    _within_one_level(got["logits"], ref["logits"], "logits")
    want = np.asarray(JG.generate(model, variables, jnp.asarray(tokens), 6))
    out = G.generate(bundle, tokens, 6, device="cpu")
    np.testing.assert_array_equal(out.numpy(), want)


def test_jax_prequantized_variables_bridge_to_the_same_outputs():
    """The JAX package's 'quant' collection lands in wq / ws: the bridged
    bundle holds its int8 weights bit for bit and scores as the
    port-side prequantized bundle does."""
    model, variables, bundle, tokens = _lm_case()
    qvars = JQ.prequantize(model, variables, jnp.asarray(tokens))
    bridged = from_flax_variables("transformer_lm", jax.device_get(qvars),
                                  dict(LM, quant=True), input_shape=(12,),
                                  dtype="float32")
    np.testing.assert_array_equal(
        bridged.state_dict["blocks.1.qkv.wq"],
        np.asarray(qvars["quant"]["block1"]["qkv"]["wq"]).T)
    np.testing.assert_array_equal(bridged.state_dict["head.ws"],
                                  np.asarray(qvars["quant"]["head"]["ws"]))
    pre = prequantize(bundle)
    for k in bridged.state_dict:
        np.testing.assert_array_equal(bridged.state_dict[k],
                                      pre.state_dict[k], err_msg=k)
    np.testing.assert_array_equal(_port_taps(bridged, tokens)["logits"],
                                  _port_taps(pre, tokens)["logits"])


def test_prequantize_matches_on_the_fly_exactly():
    _model, _variables, bundle, x = _vit_case()
    pre = prequantize(bundle)
    assert pre.bundle_id != bundle.bundle_id
    assert pre.state_dict["blocks.0.qkv.wq"].dtype == np.int8
    assert "head.wq" not in pre.state_dict
    np.testing.assert_array_equal(_port_taps(pre, x)["logits"],
                                  _port_taps(bundle, x)["logits"])


def test_prequantize_recomputes_a_stale_int8_copy():
    _model, _variables, bundle, _x = _vit_case()
    q1 = prequantize(bundle)
    scaled = TorchBundle(q1.builder, q1.builder_kwargs, state_dict={
        k: (v * 3.0 if v.dtype == np.float32 and not k.endswith(".ws")
            else v) for k, v in q1.state_dict.items()},
        input_shape=q1.input_shape, dtype=q1.dtype)
    q2 = prequantize(scaled)
    assert not np.allclose(q1.state_dict["blocks.0.qkv.ws"],
                           q2.state_dict["blocks.0.qkv.ws"])


def test_a_corrupted_int8_copy_changes_the_generation():
    """Decode reads the prequantized weights: negating one int8 copy
    (f32 weights untouched) changes the tokens (test_quant.py:110-117)."""
    _model, _variables, bundle, tokens = _lm_case()
    pre = prequantize(bundle)
    out = G.generate(pre, tokens, 6, device="cpu")
    sd = copy.deepcopy(pre.state_dict)
    sd["blocks.0.qkv.wq"] = -sd["blocks.0.qkv.wq"]
    bad = TorchBundle(pre.builder, pre.builder_kwargs, state_dict=sd,
                      input_shape=pre.input_shape, dtype=pre.dtype)
    out_bad = G.generate(bad, tokens, 6, device="cpu")
    assert not np.array_equal(out.numpy(), out_bad.numpy())


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------

def test_a_quant_vit_bundle_through_the_featurizer():
    model, variables, bundle, x = _vit_case()
    rows = [array_to_image_row(a.astype(np.uint8)) for a in x]
    out = ImageFeaturizer(bundle=bundle, batch_size=4, normalize=False,
                          device="cpu").transform(Table({"image": rows}))
    feats = np.stack(list(out["features"]))
    assert feats.shape == (3, 192) and np.all(np.isfinite(feats))
    # 32x32 rows at a 32x32 model: no resize, and the three rows run as
    # one chunk (the per-tensor activation scale couples a chunk's rows),
    # so the features are the pool tap of the same three images
    np.testing.assert_array_equal(feats, _port_taps(bundle, x)["pool"])


@pytest.mark.parametrize("paged", [False, True])
def test_a_prequantized_lm_through_generate_and_the_batcher(paged):
    """The prequantized bundle through `generate` and through a
    ContinuousBatcher, against the JAX package's on its prequantized
    variables.  The per-tensor activation scale couples the rows a
    layer runs over, so each side must run the same row sets: one slot,
    one stream at a time, so that every prefill is the one-row bucket of
    16 and every decode step one row on both sides."""
    from mmlspark_tpu.serving.batcher import ContinuousBatcher as JBatcher

    model, variables, bundle, tokens = _lm_case()
    qvars = jax.device_get(JQ.prequantize(model, variables,
                                          jnp.asarray(tokens)))
    pre = prequantize(bundle)
    n_new = 5
    want = np.asarray(JG.generate(model, qvars, jnp.asarray(tokens), n_new))
    np.testing.assert_array_equal(
        G.generate(pre, tokens, n_new, device="cpu").numpy(), want)
    kw = dict(max_slots=1, paged=paged, page_size=16)
    got = {}
    for name, batcher, wait in (
            ("port", ContinuousBatcher(pre, device="cpu", **kw),
             {"timeout": 120}),
            ("jax", JBatcher(model, qvars, **kw), {})):
        batcher.start()
        try:
            got[name] = [batcher.submit(p, n_new).tokens(**wait)
                         for p in tokens]
        finally:
            batcher.stop()
    assert [len(t) for t in got["port"]] == [n_new] * len(tokens)
    assert got["port"] == got["jax"]
