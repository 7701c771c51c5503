"""The port's sequence parallelism (mmlspark_tpu_torch/parallel/
ring_attention.py) against the JAX package's.

The port runs ring and Ulysses attention on 4 gloo ranks, each rank
holding its block of the sequence (tests/torch_dist_worker.py, spawned
once for this module); the JAX package runs its own on a 4-device mesh
of the suite's virtual CPU devices (its flash blocks through Pallas in
interpret mode, as its own tests run them).  Cases: the reference
fixture of tests/test_sequence_parallel.py, (2, 64, 8, 16), in f32 and
bf16, and a D=64 shape, (1, 128, 4, 64), causal and not; the gradients
of the ring and of Ulysses (against the JAX package's dense gradient,
which its own tests hold its ring to); the seq-axis default on a data x seq mesh;
Ulysses refusing heads the axis size does not divide.  Tolerances are
that file's: 2e-5 (f32 against dense), 0.02 (bf16 ring against bf16
dense), gradients atol 5e-4 / rtol 1e-3.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu.parallel.ring_attention import (full_attention as j_full,
                                                  ring_attention as j_ring,
                                                  ulysses_attention as j_uly)

from torch_dist_worker import run_ranks

WORLD = 4
CASES = {"ref": ((2, 64, 8, 16), 0, np.float32),
         "ref_bf16": ((2, 64, 8, 16), 0, "bfloat16"),
         "d64": ((1, 128, 4, 64), 5, np.float32)}
GRADS = ("ref", "d64")
F32, BF16 = 2e-5, 0.02
GTOL = dict(atol=5e-4, rtol=1e-3)


def _qkv(name):
    shape, seed, _dtype = CASES[name]
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _jnp(x, name):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if CASES[name][2] == "bfloat16" else a


def _torch(x, name):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if CASES[name][2] == "bfloat16" else t


@functools.lru_cache(maxsize=None)
def _mesh():
    return jax_make_mesh(data=WORLD, devices=jax.devices()[:WORLD])


@functools.lru_cache(maxsize=None)
def _jax(name, algo, causal):
    q, k, v = (_jnp(x, name) for x in _qkv(name))
    if algo == "full":
        return np.asarray(j_full(q, k, v, causal=causal))
    fn = j_ring if algo == "ring" else j_uly
    return np.asarray(fn(q, k, v, _mesh(), causal=causal))


@functools.lru_cache(maxsize=None)
def _jax_grads(name, algo):
    q, k, v = (_jnp(x, name) for x in _qkv(name))
    assert algo == "full"
    g = jax.grad(lambda a, b, c: jnp.sum(j_full(a, b, c, causal=True) ** 2),
                 argnums=(0, 1, 2))(q, k, v)
    return tuple(np.asarray(x) for x in g)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {}
    for name in CASES:
        q, k, v = (_torch(x, name) for x in _qkv(name))
        cases[name] = {"q": q, "k": k, "v": v, "grads": name in GRADS}
    return run_ranks("seqpar", {"cases": cases},
                     tmp_path_factory.mktemp("seqpar"), world=WORLD)


def _whole(results, key):
    """The ranks' sequence blocks joined into the full output."""
    return torch.cat([r[key] for r in results], dim=1).float().numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("algo", ["ring", "ulysses"])
@pytest.mark.parametrize("name", ["ref", "d64"])
def test_f32_matches_dense_and_the_jax_package(ranks, name, algo, causal):
    got = _whole(ranks, (name, algo, causal))
    np.testing.assert_allclose(got, _jax(name, "full", causal), atol=F32,
                               rtol=F32)
    np.testing.assert_allclose(got, _jax(name, algo, causal), atol=F32,
                               rtol=F32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("algo", ["ring", "ulysses"])
def test_bf16_tracks_bf16_dense(ranks, algo, causal):
    """bf16 q/k/v (f32 accumulation and softmax statistics): the port's
    sequence-parallel result tracks the JAX package's bf16 dense result
    under the same quantization, as the reference test holds its ring."""
    got = _whole(ranks, ("ref_bf16", algo, causal))
    np.testing.assert_allclose(got, _jax("ref_bf16", "full", causal),
                               atol=BF16, rtol=BF16)


@pytest.mark.parametrize("algo", ["ring", "ulysses"])
@pytest.mark.parametrize("name", GRADS)
def test_gradients_match_the_jax_package(ranks, name, algo):
    """dq, dk AND dv of sum(attention(q, k, v)**2), causal: each rank's
    block of the port's gradient (the ring through its dense-ring
    recompute, Ulysses through the all-to-alls and the flash backward)
    equals the JAX package's gradient of the same function — the dense
    one, which its own tests hold its ring and Ulysses to."""
    want = _jax_grads(name, "full")
    for i in range(3):
        got = torch.cat([r[(name, algo, "grads")][i] for r in ranks],
                        dim=1).numpy()
        np.testing.assert_allclose(got, want[i], **GTOL)


def test_seq_axis_default_on_mixed_mesh(ranks):
    """On a data=2 x seq=2 mesh both attentions default to the seq axis:
    the two seq ranks of each data group hold the halves of the sequence."""
    want = _jax("ref", "full", True)
    half = want.shape[1] // 2
    for r in ranks:
        ring, uly, i = r["mixed"]
        sl = slice(i * half, (i + 1) * half)
        np.testing.assert_allclose(ring.numpy(), want[:, sl], atol=F32,
                                   rtol=F32)
        np.testing.assert_allclose(uly.numpy(), want[:, sl], atol=F32,
                                   rtol=F32)


def test_ulysses_rejects_bad_heads(ranks):
    for r in ranks:
        assert r["bad_heads"] is not None and "heads" in r["bad_heads"]
