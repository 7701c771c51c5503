"""The port's flash-attention backward (mmlspark_tpu_torch.ops.
attention_kernels: the plain versions of B5/B6 and `fused_attention`'s
autograd) held against the JAX package's: the Pallas backward kernels
`_attention_bwd_dkdv` / `_attention_bwd_dq` in interpret mode, as the JAX
package's own tests run them on the CPU, and `jax.grad` of its
`fused_attention` (its custom VJP), on the same numpy inputs.

Tolerance: 1e-4 abs, the JAX suite's off-TPU `GRAD_TOL`
(test_attention_kernels.py:27) — both sides compute in f32, summed in
another order.

On the CPU the wrappers take the plain versions; the kernels themselves
are held against those plain versions on the card (tests/
test_torch_cuda.py, chip_smoke.py).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import transformer as T
from mmlspark_tpu.ops import attention_kernels as JK
from mmlspark_tpu_torch.models import transformer as PT
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.ops import attention_kernels as K
from mmlspark_tpu_torch.parallel.ring_attention import full_attention

from torch_port_util import random_transformer_params

torch.set_num_threads(2)

GRAD_TOL = dict(atol=1e-4, rtol=0)
LANE = 128


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _to_bhsd(x):
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _from_bhsd(x, shape):
    b, s, h, d = shape
    return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)


@functools.lru_cache(maxsize=None)
def _jax_kernels(s, causal):
    """dK, dV, dQ of the JAX Pallas kernels (interpret mode) and the
    inputs: q, k, v, dO (B, S, H, D), lse and delta [B*H, S]."""
    shape = (2, s, 2, 64)
    q, k, v, do = _inputs(s + int(causal), shape)
    out, lse = K.flash_attention_fwd_plain(*(torch.from_numpy(x)
                                            for x in (q, k, v)), causal)
    delta = np.einsum("bshd,bshd->bhs", do, out.numpy()).reshape(4, s)
    lse = lse.numpy()
    lane = lambda x: jnp.broadcast_to(jnp.asarray(x)[..., None],  # noqa: E731
                                      (4, s, LANE))
    args = [jnp.asarray(_to_bhsd(x)) for x in (q, k, v, do)]
    scale = 1.0 / 8.0
    dk, dv = JK._attention_bwd_dkdv(*args, lane(lse), lane(delta), causal,
                                    scale)
    dq = JK._attention_bwd_dq(*args, lane(lse), lane(delta), causal, scale)
    refs = tuple(_from_bhsd(x, shape) for x in (dk, dv, dq))
    return (q, k, v, do, lse, delta.astype(np.float32)), refs


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [128, 256])
def test_plain_bwd_matches_jax_pallas_kernels(s, causal):
    (q, k, v, do, lse, delta), (ref_dk, ref_dv, ref_dq) = _jax_kernels(
        s, causal)
    tq, tk, tv, tdo, tlse, tdelta = (torch.from_numpy(x)
                                     for x in (q, k, v, do, lse, delta))
    dk, dv = K.flash_attention_bwd_dkdv_plain(tq, tk, tv, tdo, tlse, tdelta,
                                              causal)
    dq = K.flash_attention_bwd_dq_plain(tq, tk, tv, tdo, tlse, tdelta, causal)
    for name, got, ref in (("dk", dk, ref_dk), ("dv", dv, ref_dv),
                           ("dq", dq, ref_dq)):
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), ref, err_msg=name, **GRAD_TOL)
    # on CPU tensors the wrappers are the plain versions, with no launch
    before = (K.LAUNCHES_BWD_DKDV, K.LAUNCHES_BWD_DQ)
    wdk, wdv = K.flash_attention_bwd_dkdv(tq, tk, tv, tdo, tlse, tdelta,
                                          causal)
    wdq = K.flash_attention_bwd_dq(tq, tk, tv, tdo, tlse, tdelta, causal)
    assert (K.LAUNCHES_BWD_DKDV, K.LAUNCHES_BWD_DQ) == before
    assert torch.equal(wdk, dk) and torch.equal(wdv, dv) and \
        torch.equal(wdq, dq)


def _jax_grads(q, k, v, g, causal):
    def f(q, k, v):
        return jnp.sum(JK.fused_attention(q, k, v, causal) * g)

    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("s,causal", [(128, True), (128, False), (100, True),
                                      (77, True), (20, False)])
def test_fused_attention_grads_match_jax_grad(s, causal):
    """128: the JAX side's Pallas backward in interpret mode; 100: a ragged
    length it pads to 128 (kv_valid masking) and still takes its kernels
    for; 77 and 20: ragged lengths where it falls back to its dense XLA
    gradients."""
    q, k, v, g = _inputs(s, (2, s, 2, 64))
    refs = _jax_grads(q, k, v, g, causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = K.fused_attention(tq, tk, tv, causal)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, got, ref in zip("qkv", grads, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg=f"d{name}", **GRAD_TOL)
    dense = torch.autograd.grad(full_attention(tq, tk, tv, causal), (tq, tk, tv),
                                torch.from_numpy(g))
    for got, ref in zip(grads, dense):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **GRAD_TOL)


def test_fused_attention_without_grad_runs_the_forward_only():
    q, k, v, _g = (torch.from_numpy(x) for x in _inputs(3, (1, 16, 2, 8)))
    with torch.no_grad():
        out = K.fused_attention(q.requires_grad_(), k, v, True)
    assert out.grad_fn is None
    with torch.inference_mode():
        assert K.fused_attention(q, k, v, True).grad_fn is None


def test_a_strided_grad_output_reads_like_a_contiguous_one():
    """Autograd may hand the backward a grad_output with any strides (here
    an expanded one, stride 0 along the batch)."""
    q, k, v, g = _inputs(4, (2, 40, 2, 16))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    g1 = torch.from_numpy(g[:1]).expand(2, -1, -1, -1)
    assert g1.stride(0) == 0
    got = torch.autograd.grad(K.fused_attention(tq, tk, tv, True),
                              (tq, tk, tv), g1)
    ref = torch.autograd.grad(K.fused_attention(tq, tk, tv, True),
                              (tq, tk, tv), g1.contiguous())
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_bwd_wrappers_reject_mismatched_inputs():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, (1, 8, 2, 16)))
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        K.flash_attention_bwd_dq(q, k, v, do[:, :4], lse, lse, True)
    with pytest.raises(ValueError):
        K.flash_attention_bwd_dkdv(q, k, v, do, lse[:1], lse, True)
    with pytest.raises(ValueError):
        K.flash_attention_bwd_dkdv(q, k, v, do, lse, lse.double(), True)


@functools.lru_cache(maxsize=None)
def _gqa_case():
    kw = dict(vocab_size=64, embed_dim=128, num_heads=2, max_len=128,
              num_layers=1, num_kv_heads=1)
    model = T.transformer_lm(dtype=jnp.float32, **kw)
    tokens = np.random.default_rng(6).integers(0, 64, (2, 128)).astype(
        np.int32)
    variables = random_transformer_params(model, jnp.asarray(tokens), seed=7)
    return kw, model, variables, tokens


def test_gqa_block_grads_match_jax(monkeypatch):
    """A GQA block (2 query heads over 1 K/V head, D 64): gradients of every
    parameter through the kernel path and `_gqa_expand`'s repeat, against
    `jax.grad` with the JAX block on its Pallas kernels (interpret mode)."""
    monkeypatch.setattr(T, "_single_tpu", lambda: True)
    kw, model, variables, tokens = _gqa_case()

    def loss(params):
        logits, _ = model.apply({"params": params}, jnp.asarray(tokens))
        return jnp.mean(logits ** 2)

    ref = from_flax_variables("transformer_lm",
                              {"params": jax.grad(loss)(variables["params"])},
                              kw, input_shape=(128,), dtype="float32"
                              ).state_dict
    bundle = from_flax_variables("transformer_lm", variables, kw,
                                 input_shape=(128,), dtype="float32")
    module = bundle.module(torch.device("cpu"))
    assert isinstance(module, PT.TransformerLM) and module.kv_heads == 1
    logits, _ = module(torch.from_numpy(tokens))
    (logits ** 2).mean().backward()
    for name, p in module.named_parameters():
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(p.grad.numpy(), ref[name], err_msg=name,
                                   atol=1e-4 * scale, rtol=0)
