"""The port's attention (mmlspark_tpu_torch.parallel.ring_attention and
ops.attention_kernels) held against the JAX package's: `full_attention`,
`fused_attention` and the Pallas kernel's logsumexp (`_run_kernel`, in
interpret mode on the CPU, as the JAX package's own tests run it), on the
same numpy inputs.

Tolerances.  f32: 2e-5 abs and rel, the JAX suite's CPU `F32_TOL`
(test_attention_kernels.py:26) — both sides compute in true f32, in
another summation order.  bf16 inputs: 2e-2, the JAX suite's bf16
tolerance — the kernel rounds the probabilities to bf16 before the PV
product, unnormalized, where the dense version rounds them normalized.

On the CPU the wrapper takes the plain version; the kernel itself is
held against that plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.ops import attention_kernels as JK
from mmlspark_tpu.parallel.ring_attention import full_attention as j_full
from mmlspark_tpu_torch.ops import attention_kernels as K
from mmlspark_tpu_torch.parallel.ring_attention import (attention_with_lse,
                                                        full_attention)

torch.set_num_threads(2)

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [128, 196])
def test_full_attention_matches_jax_f32(s, d, causal):
    q, k, v = _qkv(s + d, (1, s, 2, d))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref_full = np.asarray(j_full(jq, jk, jv, causal=causal))
    ref_fused = np.asarray(JK.fused_attention(jq, jk, jv, causal))
    _o, ref_lse = JK._run_kernel(jq, jk, jv, causal)  # interpret mode
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = full_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (1, s, 2, d)
    np.testing.assert_allclose(got.numpy(), ref_full, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), ref_fused, **F32_TOL)
    out, lse = K.flash_attention_fwd(tq, tk, tv, causal)  # CPU: plain
    np.testing.assert_allclose(out.numpy(), got.numpy(), rtol=0, atol=0)
    assert lse.shape == (2, s)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax_fused_attention(causal):
    q, k, v = _qkv(5, (2, 196, 2, 64))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(JK.fused_attention(jq, jk, jv, causal))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = K.fused_attention(tq, tk, tv, causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **BF16_TOL)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, (2, 70, 3, 32)))
    before = K.LAUNCHES
    out, lse = K.flash_attention_fwd(q, k, v, True)
    assert K.LAUNCHES == before
    ref, ref_lse = attention_with_lse(q, k, v, True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_strided_qkv_views_read_like_contiguous_ones():
    """The transformer hands over the three head-axis slices of one
    (B, S, 3H, D) projection, not contiguous tensors."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 50, 9, 16)).astype(
        np.float32))
    q, k, v = qkv.split(3, dim=2)
    assert not q.is_contiguous()
    got = K.fused_attention(q, k, v, True)
    ref = K.fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=0)


def test_wrapper_rejects_mismatched_inputs():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, (1, 8, 2, 16)))
    with pytest.raises(ValueError):
        K.flash_attention_fwd(q, k[:, :4], v, False)
    with pytest.raises(TypeError):
        K.flash_attention_fwd(q, k.double(), v, False)
    with pytest.raises(ValueError):
        K.flash_attention_fwd(q[0], k[0], v[0], False)
