"""Tests of mmlspark_tpu_torch that need a CUDA card: each kernel against
its plain PyTorch version on the card, and the card paths that run them
(the featurizer over a ResNet and a ViT, `generate` over a TransformerLM,
the ContinuousBatcher's paged decode, also behind a two-replica fleet
gateway, and the flash backward under a TransformerLM's
`loss.backward()`).
They skip without a card (the kernels have no CPU mode).  This file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the resize kernel atol=1e-3, rtol=1e-4 in normalized units,
as for its CPU parity test against the JAX package
(test_torch_image_kernels.py); the attention kernel 1e-4 abs for f32
inputs and 2e-2 for bf16 (it rounds the probabilities to bf16
unnormalized, the plain version normalized), its logsumexp 1e-4; the
paged attention kernels 1e-4 abs (both sides compute in f32 from the same
stored values); the backward kernels 1e-4 abs for f32 inputs and 1e-2 for
bf16 (both sides round p and ds to bf16 at the same points, but the
kernel's p differs from the plain version's in its last f32 bits — exp2,
another summation order — which can move an element's bf16 rounding by
one step; observed 2.8e-3 on the H100), and each of their outputs within
1e-3 relative L2 of the plain version's (the max-abs limit is set by the
few large entries near the first keys and would pass a kernel ~10% off
on later tiles; observed ~5e-5); a bf16 TransformerLM's
gradients through the kernels within 5e-2 relative L2 of each
parameter's gradient through `full_attention` (the forwards differ by
B4's bf16 rounding of P, unnormalised against normalised; observed
1.5e-2 at 2 layers); the normalize+unroll kernel 1e-6 abs (the JAX
package's own limit; both sides round the same two f32 ops, so it is
bit-exact); the RLE decode kernel exact to the byte.

The port's JPEG decoder (`mmlspark_tpu_torch.native`) against the
libjpeg digests of tests/jpeg_fixtures/ (progressive, restart-interval
and arithmetic-coded streams among them, which nvJPEG may also refuse to
PIL, never raise on; frames other than 8-bit SOF0/1/2 it refuses):
byte-exact where it builds on
libjpeg; on nvJPEG (a machine without libjpeg's headers) a mean absolute
difference of at most 0.089 levels on the digests' pixel sample and a
mean of at most 0.0077 a channel — the C2 kernel upsamples and converts
nvJPEG's planes with libjpeg's arithmetic, so only nvJPEG's IDCT differs,
which gave at most 0.059 and 0.0051 on an H100 machine (the limits are
1.5x those; nvJPEG's own chroma path gave 13.1-13.5 and 0.46-0.50).  C2
against its plain version byte for byte, on the fixtures' planes and on
4:4:4, 4:2:2 and 4:2:0 images of odd sizes.  The JPEG featurizer on the
card against its CPU run on the same decoded pixels at the featurizer
test's f32 limits.  A CUDA TrainState round-trips a checkpoint bit for
bit, also into a live state a poisoned step filled with NaN.

The GBDT engine (no kernel of its own): the dense and COO histograms on
the card within 1e-4 of the node's absolute mass of the plain function
on the CPU (the card's atomics add in another order), at three shapes
each, one of 2^18 features; two builds of one node compared (whether
bit for bit is printed); the forest predictor on the card within 1e-4
of the host traversal; a booster fit on the card against its CPU fit by
the tie rule of tests/torch_gbdt_compare.py.

The classic-ML slice (no kernel of its own): the linear learners' card
fits against their CPU fits at the CPU parity test's tolerances
(tests/test_torch_linear.py: weights within 1e-4 of max |w|, scores
within 1e-5; the f64 ridge within 1e-9), the same fit under a process's
TF32 setting on and off (within 1e-6), `TrainClassifier` /
`TrainRegressor` on the card by default, and the host library built by
that machine's g++, equal to its plain versions.

The rest of classic ML: K1 (the online learners' pass) against its
plain loop with duplicated indices, explicit zeros and all-zero rows at
1, 2, 4 and 8 slots a lane, for the logistic, squared and bandit losses
(weights within 1e-5 of max |w|: only the order of each prediction's sum
differs), and two launches from one state equal bit for bit; its
wrapper's refusals; the classifier's card fit against its CPU fit
(1e-5); Word2Vec's card fit against its CPU fit on one set of negatives
(1e-4 of max |v|); KNN's top-k on integer keys equal on both devices,
ties included; SAR's similarities (exact co-occurrence, 1e-6) and
recommendations (a list may differ only at a 1e-5 near-tie); the
isolation forest's scores (1e-6); the tagger's card fit against its CPU
fit (1e-3 of each tensor's largest, cuDNN's LSTM in full f32); a convnet
featurizer through B1 against its CPU run (1e-3).

The explainers and CyberML (no kernel of their own): the batched f32 WLS
on the card against the f64 host solve and the lasso against its CPU run
(coefficients and intercepts within 1e-4 of max |coef| and max |y|:
cuBLAS and cuSOLVER round in another order); `TabularLIME` on the card by default against its
CPU run (1e-4); the ALS sweep on the card against the CPU (1e-5 of the
largest factor: its observed sums accumulate in f64, the card's atomics
in another order); two `AccessAnomaly` card fits at the defaults (scores
within 1e-6 of the largest, whether bit for bit printed) and one against
its CPU fit from the same initial factors (1e-4).

The fit's direct init: a backbone placed on the card uninitialised and
filled from a pinned host draw with one copy, bit for bit
`init_state_dict`'s on the host.
"""
import base64
import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.models.bundle import (TorchBundle, get_builder,
                                              init_state_dict)
from mmlspark_tpu_torch.models.generation import generate
from mmlspark_tpu_torch.models.training import lm_loss
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.io.feed import DeviceFeed, FeedTelemetry
from mmlspark_tpu_torch.ops import attention_kernels as A
from mmlspark_tpu_torch.ops import image_kernels as K
from mmlspark_tpu_torch.ops import image_stages as S
from mmlspark_tpu_torch.ops import paged_attention as PA
from mmlspark_tpu_torch.ops import wire_codec as W
from mmlspark_tpu_torch.ops.quant import quantize_kv_row
from mmlspark_tpu_torch.parallel.ring_attention import full_attention
from mmlspark_tpu_torch.serving.batcher import ContinuousBatcher

torch.set_num_threads(2)

ATOL, RTOL = 1e-3, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,out_hw", [
    ("uint8", (4, 256, 256, 3), (224, 224)),
    ("uint8", (4, 320, 240, 3), (224, 224)),
    ("uint8", (3, 224, 224, 3), (224, 224)),
    ("float32", (2, 37, 53, 1), (224, 224)),
    ("uint8", (2, 19, 23, 4), (7, 31)),
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, shape, out_hw):
    rng = np.random.default_rng(1)
    if dtype == "uint8":
        x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    else:
        x = rng.uniform(0, 255, size=shape).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda_device)
    c = shape[3]
    plan = K.resize_plan(shape[1], shape[2], c, *out_hw,
                         (100.0,) * c, (50.0,) * c)
    before = K.LAUNCHES
    got = K.affine_resample(xt, plan)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    ref = K.affine_resample_plain(xt, plan)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_kernel_rejects_a_strided_batch(cuda_device):
    x = torch.zeros(2, 8, 8, 4, dtype=torch.uint8, device=cuda_device)
    plan = K.resize_plan(8, 8, 3, 4, 4, (0.0,) * 3, (1.0,) * 3)
    with pytest.raises(ValueError):
        K.affine_resample(x[..., :3], plan)


@pytest.mark.cuda
def test_featurizer_on_card_launches_the_kernel_per_chunk(cuda_device):
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=s, dtype=np.uint8)
              for s in [(40, 40, 3), (32, 32, 3), (40, 40, 3), (48, 36, 1),
                        (40, 40, 3)]]
    # random BatchNorms: under flax's init every residual branch is 0 and
    # the check would see only the stem and the projection convs
    state = init_state_dict(get_builder("resnet18")(num_classes=10), seed=0,
                            random_bn=True)
    bundle = TorchBundle("resnet18", {"num_classes": 10}, state_dict=state,
                         input_shape=(32, 32, 3), dtype="float32")
    K.LAUNCHES = 0
    got = ImageFeaturizer(bundle=bundle, batch_size=2).transform(
        Table({"image": images}))["features"]
    # chunks: 40x40 group of 3 -> 2 chunks, 32x32 -> 1, gray 48x36 -> 1
    assert K.LAUNCHES == 4
    ref = ImageFeaturizer(bundle=bundle, batch_size=2, device="cpu").transform(
        Table({"image": images}))["features"]
    assert got.shape == ref.shape == (5, 512)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal", [
    ((4, 196, 12, 64), torch.bfloat16, False),
    ((2, 1000, 4, 64), torch.bfloat16, True),
    ((3, 77, 5, 64), torch.float32, True),
    ((2, 130, 3, 32), torch.bfloat16, True),
    ((2, 65, 2, 256), torch.float32, False),
    ((1, 100, 2, 40), torch.bfloat16, False),
    # the batcher's admission prefills: kp rows at a power-of-two bucket
    ((8, 1024, 12, 64), torch.bfloat16, True),
    ((1, 16, 12, 64), torch.bfloat16, True),
])
def test_attention_kernel_matches_plain_on_card(cuda_device, shape, dtype,
                                                causal):
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(3))
    before = A.LAUNCHES
    out, lse = A.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert A.LAUNCHES == before + 1
    ref, ref_lse = A.flash_attention_fwd_plain(q, k, v, causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_attention_kernel_reads_strided_qkv_views(cuda_device):
    qkv = torch.randn(2, 196, 3 * 4, 64, device=cuda_device).bfloat16()
    q, k, v = qkv.split(4, dim=2)
    got = A.fused_attention(q, k, v, False)
    ref = A.fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            False)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_attention_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.randn(1, 16, 64, 2, device=cuda_device).bfloat16()
    strided = x.permute(0, 1, 3, 2)  # (B, S, H, D) with d stride 2
    with pytest.raises(ValueError):
        A.flash_attention_fwd(strided, strided, strided, True)
    half = torch.randn(1, 16, 2, 64, device=cuda_device).half()
    with pytest.raises(TypeError):
        A.flash_attention_fwd(half, half, half, True)
    wide = torch.randn(1, 16, 1, 264, device=cuda_device)
    with pytest.raises(ValueError):
        A.flash_attention_fwd(wide, wide, wide, True)
    odd = torch.randn(1, 16, 2, 36, device=cuda_device).bfloat16()
    with pytest.raises(ValueError):
        A.flash_attention_fwd(odd, odd, odd, True)


@pytest.mark.cuda
def test_generate_on_card_runs_the_kernel_in_prefill_only(cuda_device):
    kw = dict(vocab_size=64, embed_dim=128, num_layers=2, num_heads=2,
              max_len=96)
    bundle = TorchBundle("transformer_lm", kw, input_shape=(64,),
                         dtype="float32", seed=1)
    prompt = np.random.default_rng(3).integers(0, 64, (2, 70)).astype(
        np.int32)
    A.LAUNCHES = 0
    got = generate(bundle, prompt, 8)
    torch.cuda.synchronize()
    assert A.LAUNCHES == 2  # the prefill, one per layer; decode: none
    ref = generate(bundle, prompt, 8, device="cpu")
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_vit_featurizer_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, size=s, dtype=np.uint8)
              for s in [(40, 40, 3), (32, 32, 3), (40, 40, 3)]]
    bundle = TorchBundle("vit_tiny", {"num_classes": 10},
                         input_shape=(32, 32, 3), dtype="float32", seed=2)
    A.LAUNCHES = 0
    K.LAUNCHES = 0
    got = ImageFeaturizer(bundle=bundle, batch_size=2).transform(
        Table({"image": images}))["features"]
    assert K.LAUNCHES == 2 and A.LAUNCHES == 2 * 12
    ref = ImageFeaturizer(bundle=bundle, batch_size=2, device="cpu").transform(
        Table({"image": images}))["features"]
    assert got.shape == ref.shape == (3, 192)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3 * scale)


def _paged_inputs(device, b, h, hkv, d, page, mp, dtype, positions, seed):
    """q and garbage-filled pools (trash page 0 included); each slot owns
    distinct pages for its live positions, the rest of its table is 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    live = [p // page + 1 for p in positions]
    n_pages = 1 + sum(live)
    q = torch.randn((b, h, d), device=device, generator=gen).to(dtype)
    k, v = (torch.randn((n_pages, page, hkv, d), device=device,
                        generator=gen).to(dtype) for _ in range(2))
    table = np.zeros((b, mp), np.int32)
    nxt = 1
    for i, n in enumerate(live):
        table[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return (q, k, v, torch.from_numpy(table).to(device),
            torch.tensor(positions, dtype=torch.int32, device=device))


PAGED_CASES = [  # (b, h, hkv, d, page, mp, dtype, positions)
    (8, 12, 12, 64, 64, 16, torch.bfloat16,
     [0, 63, 64, 1023, 500, 129, 900, 7]),
    (8, 12, 12, 64, 64, 16, torch.float32,
     [0, 63, 64, 1023, 500, 129, 900, 7]),
    (4, 12, 4, 64, 64, 16, torch.bfloat16, [5, 700, 64, 1000]),
    (3, 4, 4, 32, 16, 8, torch.float32, [0, 17, 127]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernels_match_plain_on_card(cuda_device, case):
    b, h, hkv, d, page, mp, dtype, positions = case
    q, k, v, table, pos = _paged_inputs(cuda_device, b, h, hkv, d, page, mp,
                                        dtype, positions, seed=5)
    before = PA.LAUNCHES
    got = PA.paged_decode_attention(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert PA.LAUNCHES == before + 1
    ref = PA.paged_decode_attention_plain(q, k, v, table, pos)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    kq, ks = quantize_kv_row(k)
    vq, vs = quantize_kv_row(v)
    before = PA.LAUNCHES_INT8
    got8 = PA.paged_decode_attention_int8(q, kq, ks, vq, vs, table, pos)
    torch.cuda.synchronize()
    assert PA.LAUNCHES_INT8 == before + 1
    ref8 = PA.paged_decode_attention_int8_plain(q, kq, ks, vq, vs, table, pos)
    np.testing.assert_allclose(got8.cpu().numpy(), ref8.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_paged_kernels_reject_what_they_cannot_take(cuda_device):
    q, k, v, table, pos = _paged_inputs(cuda_device, 2, 4, 4, 64, 16, 4,
                                        torch.float32, [3, 40], seed=6)
    with pytest.raises(TypeError):
        PA.paged_decode_attention(q.to(torch.int32), k, v, table, pos)
    with pytest.raises(TypeError):
        PA.paged_decode_attention(q, k, v, table.long(), pos)
    with pytest.raises(TypeError):
        PA.paged_decode_attention(q.bfloat16(), k, v, table, pos)
    wide = torch.zeros(2, 4, 260, device=cuda_device)
    pool = torch.zeros(4, 16, 4, 260, device=cuda_device)
    with pytest.raises(ValueError):
        PA.paged_decode_attention(wide, pool, pool, table, pos)
    with pytest.raises(ValueError):
        PA.paged_decode_attention(q, k.transpose(0, 1).contiguous()
                                  .transpose(0, 1), v, table, pos)


@pytest.mark.cuda
def test_paged_batcher_on_card_matches_generate(cuda_device):
    kw = dict(vocab_size=256, embed_dim=128, num_layers=2, num_heads=2,
              max_len=128)
    bundle = TorchBundle("transformer_lm", kw, input_shape=(16,),
                         dtype="float32", seed=4)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, n).astype(np.int32).tolist()
               for n in (5, 40, 17, 70, 1, 33)]
    PA.LAUNCHES = 0
    batcher = ContinuousBatcher(bundle, max_slots=3, paged=True,
                                page_size=16).start()
    try:
        streams = [batcher.submit(p, max_new_tokens=12) for p in prompts]
        got = [s.tokens(timeout=300) for s in streams]
    finally:
        batcher.stop()
    assert PA.LAUNCHES > 0
    for p, toks in zip(prompts, got):
        want = generate(bundle, np.asarray(p, np.int32)[None], 12)
        assert toks == want[0, len(p):].cpu().tolist(), p


@pytest.mark.cuda
def test_two_replica_fleet_on_card_streams_generate(cuda_device):
    """`distributed_server(replicas=2)` over a CUDA bundle, found by a
    gateway through the registry: every stream through the gateway is
    `generate()`'s on the card, the replicas share one batcher (one copy
    of the model and the pools: the card's memory after start is the
    one-replica query's), and the paged kernel ran."""
    import gc
    import http.client

    from mmlspark_tpu_torch.models import generation
    from mmlspark_tpu_torch.serving import (FleetGateway, ServiceRegistry,
                                            read_stream)

    kw = dict(vocab_size=256, embed_dim=128, num_layers=2, num_heads=2,
              max_len=128)
    bundle = TorchBundle("transformer_lm", kw, input_shape=(16,),
                         dtype="float32", seed=4)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, n).astype(np.int32).tolist()
               for n in (5, 40, 17, 70)]

    def start(replicas, url=None):
        return (read_stream()
                .distributed_server(name="cardfleet", path="/lm",
                                    replicas=replicas, registry_url=url)
                .parse_request(schema=["prompt"])
                .generate_stream(bundle, max_new_tokens=12, max_slots=4,
                                 paged=True, page_size=16)
                .start())

    def grown_by_start(replicas, url=None):
        """(query, bytes the card gained while it started): the model
        cache is cleared first, so each count holds the model and the
        pools."""
        generation._MODULES.clear()
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        q = start(replicas, url)
        torch.cuda.synchronize()
        return q, torch.cuda.memory_allocated() - before

    one, grown_one = grown_by_start(1)
    one.stop()
    del one
    reg = ServiceRegistry()
    url = reg.start()
    query = gw = None
    PA.LAUNCHES = 0
    results = {}
    try:
        query, grown_two = grown_by_start(2, url)
        assert grown_one > 0 and grown_two <= grown_one + (64 << 10), \
            (grown_one, grown_two)
        gw = FleetGateway(name="cardfleet", registry_url=url,
                          probe_interval_s=5.0)
        gw.start()
        assert len(gw.replicas()) == 2
        gi = gw.service_info
        for i, p in enumerate(prompts):
            conn = http.client.HTTPConnection(gi.host, gi.port, timeout=300)
            conn.request("POST", gi.path, body=json.dumps(
                {"prompt": p}).encode())
            resp = conn.getresponse()
            results[i] = (resp.status, resp.read().decode())
            conn.close()
    finally:
        if gw is not None:
            gw.stop()
        if query is not None:
            query.stop()
        reg.stop()
    assert PA.LAUNCHES > 0
    for i, p in enumerate(prompts):
        status, body = results[i]
        assert status == 200
        want = generate(bundle, np.asarray(p, np.int32)[None], 12)
        assert [int(t) for t in body.split()] == \
            want[0, len(p):].cpu().tolist(), p


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BWD_RTOL = 1e-3
GRAD_RTOL = 5e-2


def _bwd_inputs(device, shape, dtype, causal, seed):
    """q, k, v, dO and the forward's lse and delta = rowsum(dO * O)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device, dtype) for _ in range(4))
    out, lse = A.flash_attention_fwd(q, k, v, causal)
    b, s, h, _d = shape
    delta = torch.einsum("bshd,bshd->bhs", do.float(), out).reshape(
        b * h, s).contiguous()
    return q, k, v, do, lse, delta


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal", [
    ((16, 1024, 12, 64), torch.bfloat16, True),   # the LM train layer
    ((64, 196, 12, 64), torch.bfloat16, False),   # a ViT-B/16 chunk
    ((3, 77, 5, 64), torch.float32, True),        # ragged S
    ((2, 128, 4, 32), torch.float32, False),      # D 32
    ((4, 256, 4, 128), torch.bfloat16, True),     # D 128: two column chunks
    ((2, 130, 2, 256), torch.bfloat16, True),
    ((2, 100, 2, 256), torch.float32, False),     # 32-row f32 tiles
    ((2, 70, 3, 32), torch.bfloat16, False),
    ((2, 1, 2, 64), torch.bfloat16, True),
])
def test_bwd_kernels_match_plain_on_card(cuda_device, shape, dtype, causal):
    q, k, v, do, lse, delta = _bwd_inputs(cuda_device, shape, dtype, causal,
                                          seed=5)
    before = (A.LAUNCHES_BWD_DKDV, A.LAUNCHES_BWD_DQ)
    dk, dv = A.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal)
    dq = A.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (A.LAUNCHES_BWD_DKDV, A.LAUNCHES_BWD_DQ) == (before[0] + 1,
                                                        before[1] + 1)
    rk, rv = A.flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal)
    rq = A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    for name, got, ref in (("dk", dk, rk), ("dv", dv, rv), ("dq", dq, rq)):
        assert got.dtype == torch.float32 and got.shape == shape
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   atol=BWD_TOL[dtype], rtol=0, err_msg=name)
        # relative L2 over a norm of at least 1: dK and dQ at S = 1 are ~0
        rel = float((got - ref).norm() / ref.norm().clamp(min=1.0))
        assert rel <= BWD_RTOL, (name, rel)


@pytest.mark.cuda
def test_bwd_kernels_read_strided_views_and_grad_outputs(cuda_device):
    """q/k/v as the transformer hands them over (head-axis slices of one
    projection) and a grad_output autograd makes with stride 0."""
    qkv = torch.randn(2, 196, 3 * 4, 64, device=cuda_device).bfloat16()
    leaf = qkv.clone().requires_grad_()
    g = torch.randn(1, 196, 4, 64, device=cuda_device).expand(2, -1, -1, -1)
    grads = []
    for cont in (False, True):
        q, k, v = leaf.split(4, dim=2)
        if cont:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = A.fused_attention(q, k, v, True)
        grads.append(torch.autograd.grad(out, leaf, g if not cont
                                         else g.contiguous())[0])
    torch.cuda.synchronize()
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_bwd_kernels_reject_what_they_cannot_take(cuda_device):
    q, k, v, do, lse, delta = _bwd_inputs(cuda_device, (1, 16, 2, 64),
                                          torch.bfloat16, True, seed=6)
    with pytest.raises(ValueError):
        A.flash_attention_bwd_dq(q, k, v, do.transpose(2, 3).contiguous()
                                 .transpose(2, 3), lse, delta, True)
    with pytest.raises(ValueError):
        A.flash_attention_bwd_dkdv(q, k, v, do, lse[:, :8], delta, True)
    half = [x.half() for x in (q, k, v, do)]
    with pytest.raises(TypeError):
        A.flash_attention_bwd_dkdv(*half, lse, delta, True)


# The Hopper routes of B4 and B5 (bf16, D <= 128: TMA rings and wgmma)
# at the main paths' shapes — a ViT-B/16 chunk, the LM prefill, the
# batcher's admission prefill, the LM train layer — and at ragged S
# (1, 16, 77, 196, 1000, 1025), causal or not, D = 32, 64 and 128, and
# at a few other head dims.
HOPPER_CASES = [
    ((64, 196, 12, 64), False),
    ((8, 1000, 12, 64), True),
    ((8, 1024, 12, 64), True),
    ((16, 1024, 12, 64), True),
] + [((2, s, 3, d), causal) for s in (1, 16, 77, 196, 1000, 1025)
     for d in (32, 64, 128) for causal in (False, True)] + [
    # head dims the tensor maps pad with zeros to a 64-column box
    ((2, 77, 3, 8), True), ((2, 200, 2, 96), True), ((2, 130, 2, 40), False)]


def _case_id(case):
    (b, s, h, d), causal = case
    return f"{b}x{s}x{h}x{d}-{'causal' if causal else 'full'}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", HOPPER_CASES, ids=_case_id)
def test_hopper_forward_matches_plain_on_card(cuda_device, case):
    shape, causal = case
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(3))
    before = A.LAUNCHES
    out, lse = A.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert A.LAUNCHES == before + 1
    ref, ref_lse = A.flash_attention_fwd_plain(q, k, v, causal)
    assert out.dtype == torch.float32 and out.shape == shape
    assert (out - ref).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", HOPPER_CASES, ids=_case_id)
def test_hopper_dkdv_matches_plain_and_is_deterministic_on_card(cuda_device,
                                                                case):
    shape, causal = case
    q, k, v, do, lse, delta = _bwd_inputs(cuda_device, shape, torch.bfloat16,
                                          causal, seed=12)
    before = A.LAUNCHES_BWD_DKDV
    dk, dv = A.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal)
    dk2, dv2 = A.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert A.LAUNCHES_BWD_DKDV == before + 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)  # no atomics
    rk, rv = A.flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal)
    for name, got, ref in (("dk", dk, rk), ("dv", dv, rv)):
        assert got.dtype == torch.float32 and got.shape == shape
        assert (got - ref).abs().max().item() <= BWD_TOL[torch.bfloat16], name
        rel = float((got - ref).norm() / ref.norm().clamp(min=1.0))
        assert rel <= BWD_RTOL, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_hopper_routes_read_qkv_split_out_of_one_tensor(cuda_device, d):
    """q/k/v as views of one (B, S, 3, H, D) tensor: the tensor maps read
    the strides, and give what contiguous copies give, bit for bit."""
    qkv = torch.randn(2, 300, 3, 4, d, device=cuda_device).bfloat16()
    g = torch.randn(2, 300, 4, d, device=cuda_device).bfloat16()
    views = qkv.unbind(2)
    copies = [x.contiguous() for x in views]
    assert views[0].stride() != copies[0].stride()
    outs = []
    for q, k, v in (views, copies):
        out, lse = A.flash_attention_fwd(q, k, v, True)
        delta = torch.einsum("bshd,bshd->bhs", g.float(), out).reshape(
            -1, 300).contiguous()
        outs.append((out, lse) + A.flash_attention_bwd_dkdv(
            q, k, v, g, lse, delta, True))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# B6's Hopper route (bf16, D <= 128): the LM train layer, then S in
# (1, 196, 1000, 1024) x D in (32, 64, 128), causal or not.
B6_HOPPER_CASES = [((16, 1024, 12, 64), True)] + [
    ((2, s, 3, d), causal) for s in (1, 196, 1000, 1024)
    for d in (32, 64, 128) for causal in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", B6_HOPPER_CASES, ids=_case_id)
def test_hopper_dq_matches_plain_and_is_deterministic_on_card(cuda_device,
                                                              case):
    shape, causal = case
    q, k, v, do, lse, delta = _bwd_inputs(cuda_device, shape, torch.bfloat16,
                                          causal, seed=14)
    before = A.LAUNCHES_BWD_DQ
    dq = A.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dq2 = A.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert A.LAUNCHES_BWD_DQ == before + 2
    assert torch.equal(dq, dq2)  # one thread a dQ element, a fixed order
    ref = A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    assert dq.dtype == torch.float32 and dq.shape == shape
    assert (dq - ref).abs().max().item() <= BWD_TOL[torch.bfloat16]
    rel = float((dq - ref).norm() / ref.norm().clamp(min=1.0))
    assert rel <= BWD_RTOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_hopper_dq_reads_qkv_split_out_of_one_tensor(cuda_device, d):
    """B6 on q/k/v as views of one (B, S, 3, H, D) tensor, as the
    transformer hands them: what contiguous copies give, bit for bit, and
    the plain version's dQ."""
    qkv = torch.randn(2, 300, 3, 4, d, device=cuda_device).bfloat16()
    g = torch.randn(2, 300, 4, d, device=cuda_device).bfloat16()
    views = qkv.unbind(2)
    copies = [x.contiguous() for x in views]
    assert views[0].stride() != copies[0].stride()
    out, lse = A.flash_attention_fwd(*copies, True)
    delta = torch.einsum("bshd,bshd->bhs", g.float(), out).reshape(
        -1, 300).contiguous()
    got = [A.flash_attention_bwd_dq(*qkv_, g, lse, delta, True)
           for qkv_ in (views, copies)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    ref = A.flash_attention_bwd_dq_plain(*copies, g, lse, delta, True)
    assert (got[0] - ref).abs().max().item() <= BWD_TOL[torch.bfloat16]


# B7's split and merge: PAGED_CASES (pos 0, 63, 64 and 1023; f32 pools; a
# GQA pool; D 32 with 16-row pages) and slots whose every chunk but the
# first is empty, against the plain version and the split arithmetic's
# PyTorch mirror.
SPLIT_CASES = PAGED_CASES + [
    (3, 12, 12, 64, 64, 16, torch.bfloat16, [0, 63, 40]),
    (3, 6, 2, 32, 16, 8, torch.float32, [5, 0, 63]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_merge_b7_matches_plain_on_card(cuda_device, case):
    b, h, hkv, d, page, mp, dtype, positions = case
    q, k, v, table, pos = _paged_inputs(cuda_device, b, h, hkv, d, page, mp,
                                        dtype, positions, seed=9)
    before = PA.LAUNCHES
    got = PA.paged_decode_attention(q, k, v, table, pos)
    again = PA.paged_decode_attention(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert PA.LAUNCHES == before + 2  # one a call: split and merge
    assert torch.equal(got, again)  # the partials merge in a fixed order
    for ref in (PA.paged_decode_attention_plain(q, k, v, table, pos),
                PA.paged_decode_attention_split_plain(q, k, v, table, pos)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_split_merge_b7_never_reads_past_the_live_pages(cuda_device):
    """The table's unused entries point at page 0; filled with NaN, it
    must not reach the output."""
    q, k, v, table, pos = _paged_inputs(cuda_device, 4, 12, 12, 64, 64, 16,
                                        torch.bfloat16, [0, 70, 1023, 5],
                                        seed=10)
    ref = PA.paged_decode_attention_plain(q, k, v, table, pos)
    assert (table == 0).any()
    k[0] = float("nan")
    v[0] = float("nan")
    got = PA.paged_decode_attention(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_split_merge_b7_never_syncs_with_the_host(cuda_device):
    """The grid comes from the shapes alone: a call never reads pos (or
    anything else) back to the host."""
    q, k, v, table, pos = _paged_inputs(cuda_device, 8, 12, 12, 64, 64, 16,
                                        torch.bfloat16,
                                        [0, 63, 64, 1023, 500, 129, 900, 7],
                                        seed=11)
    PA.paged_decode_attention(q, k, v, table, pos)  # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = PA.paged_decode_attention(q, k, v, table, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2, 77, 3, 64), torch.float32),
    ((2, 130, 2, 256), torch.bfloat16),
    ((2, 100, 2, 192), torch.bfloat16),
])
def test_the_other_routes_still_launch_their_kernels(cuda_device, shape,
                                                     dtype):
    """f32, and bf16 with D > 128, keep the earlier kernels: each launch
    is counted and agrees with the plain version."""
    q, k, v, do, lse, delta = _bwd_inputs(cuda_device, shape, dtype, True,
                                          seed=13)
    before = (A.LAUNCHES, A.LAUNCHES_BWD_DKDV)
    out, lse2 = A.flash_attention_fwd(q, k, v, True)
    dk, dv = A.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert (A.LAUNCHES, A.LAUNCHES_BWD_DKDV) == (before[0] + 1,
                                                 before[1] + 1)
    ref, ref_lse = A.flash_attention_fwd_plain(q, k, v, True)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert (out - ref).abs().max().item() <= tol
    assert (lse2 - ref_lse).abs().max().item() <= 1e-4
    rk, rv = A.flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, True)
    for got, r in ((dk, rk), (dv, rv)):
        assert (got - r).abs().max().item() <= BWD_TOL[dtype]


def _lm_grads(cuda_device, attn_fn, kv_heads, state, tokens):
    kw = dict(vocab_size=1024, embed_dim=768, num_layers=2, num_heads=12,
              max_len=256, num_kv_heads=kv_heads)
    if attn_fn is not None:
        kw["attn_fn"] = attn_fn
    module = get_builder("transformer_lm")(**kw)
    module.load_state_dict(state)
    module = module.to(cuda_device, torch.bfloat16)
    logits, _ = module(tokens)
    lm_loss(logits, tokens).backward()
    return {n: p.grad for n, p in module.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("kv_heads", [None, 4])
def test_every_lm_parameter_gets_the_full_attention_gradient(cuda_device,
                                                             kv_heads):
    """A bf16 TransformerLM's loss.backward() on the card: every parameter
    gets a gradient (with an output of the kernel that autograd could not
    see, qkv / q / kv and ln1 would get none), equal within GRAD_RTOL to
    the one through `full_attention`; with kv_heads 4 the GQA heads'
    gradients flow back through `_gqa_expand`."""
    builder = get_builder("transformer_lm")
    state = {k: torch.from_numpy(v) for k, v in init_state_dict(
        builder(vocab_size=1024, embed_dim=768, num_layers=2, num_heads=12,
                max_len=256, num_kv_heads=kv_heads), seed=3).items()}
    tokens = torch.randint(0, 1024, (2, 256), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(4))
    before = (A.LAUNCHES, A.LAUNCHES_BWD_DKDV, A.LAUNCHES_BWD_DQ)
    got = _lm_grads(cuda_device, None, kv_heads, state, tokens)
    torch.cuda.synchronize()
    assert (A.LAUNCHES, A.LAUNCHES_BWD_DKDV, A.LAUNCHES_BWD_DQ) == tuple(
        n + 2 for n in before)
    ref = _lm_grads(cuda_device, functools.partial(full_attention,
                                                   causal=True),
                    kv_heads, state, tokens)
    assert sorted(got) == sorted(ref)
    for name, g in got.items():
        assert g is not None, name
        rel = float((g.float() - ref[name].float()).norm()
                    / ref[name].float().norm())
        assert rel <= GRAD_RTOL, (name, rel)


IMAGENET_MEAN_BGR = (103.53, 116.28, 123.675)
IMAGENET_STD_BGR = (57.375, 57.12, 58.395)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mean,std", [
    ((192, 224, 224, 3), IMAGENET_MEAN_BGR, IMAGENET_STD_BGR),
    ((5, 37, 53, 1), (0.25,), (3.0,)),
    ((3, 24, 24, 3), (120.0,), (64.0,)),
    ((2, 19, 23, 4), (1.0, 2.0, 3.0, 4.0), (5.0, 6.0, 7.0, 8.0)),
])
def test_unroll_kernel_matches_plain_on_card(cuda_device, shape, mean, std):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.rand(shape, device=cuda_device, generator=gen) * 255.0
    before = K.LAUNCHES_UNROLL
    got = K.fused_normalize_unroll(x, mean, std)
    ref = K.fused_normalize_unroll_plain(x, mean, std)
    torch.cuda.synchronize()
    assert K.LAUNCHES_UNROLL == before + 1
    assert got.shape == ref.shape == (shape[0], int(np.prod(shape[1:])))
    assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_unroll_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros(2, 8, 8, 4, device=cuda_device)
    with pytest.raises(ValueError):
        K.fused_normalize_unroll(x[..., :3])          # strided
    with pytest.raises(TypeError):
        K.fused_normalize_unroll(x.to(torch.uint8))   # not f32
    with pytest.raises(ValueError):
        K.fused_normalize_unroll(torch.zeros(1, 4, 4, 5, device=cuda_device))


def _feed_bench_chunks(n_chunks=16, chunk=16, side=224):
    """tools/feed_bench.py's default chunks: flat gray 8-pixel blocks."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 6, (chunk, side, side // 8, 1)) * 40)
            .astype(np.uint8).repeat(8, axis=2).repeat(3, axis=3)
            for _ in range(n_chunks)]


def _rle_cases():
    rng = np.random.default_rng(0)
    return {
        "feed_bench": _feed_bench_chunks(1)[0],
        "uniform": rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8),
        "zeros": np.zeros((4, 32, 32, 3), np.uint8),
        "quantized": (rng.integers(0, 6, (3, 16, 16, 3)) * 40).astype(np.uint8),
        "noise": rng.integers(0, 255, (2, 17, 13)).astype(np.uint8),
        "long_runs": np.repeat(np.arange(5, dtype=np.uint8), 1000).reshape(10, 500),
        "float32": rng.integers(0, 3, (64,)).astype(np.float32) * 0.5,
        "single": np.array([7], np.uint8),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_rle_cases()))
def test_rle_decode_kernel_is_byte_exact_on_card(cuda_device, name):
    arr = _rle_cases()[name]
    p = W.rle_encode(arr)
    v = torch.from_numpy(p.values).to(cuda_device)
    e = torch.from_numpy(p.ends).to(cuda_device)
    before = W.LAUNCHES
    got = W.decode_bytes(v, e, p.n_pad)
    ref = W.decode_bytes_plain(v, e, p.n_pad)
    torch.cuda.synchronize()
    assert W.LAUNCHES == before + 1
    assert torch.equal(got, ref)
    raw = got.cpu().numpy()[:p.nbytes_raw].view(arr.dtype).reshape(arr.shape)
    np.testing.assert_array_equal(raw, arr)


def _upper_bound_decode(values, ends, n_pad):
    """The kernel's rule on any table: out[p] = values[r], r the first of
    the first R-1 runs with ends[r] > p, else R-1."""
    idx = np.searchsorted(ends[:-1], np.arange(n_pad), side="right")
    return values[np.minimum(idx, len(values) - 1)]


def _rle_tables():
    """Tables the encoder does not make, (values, ends, n_pad)."""
    rng = np.random.default_rng(5)
    one = np.full(256, 3 * 8192, np.int32)  # one run over three tiles
    inside = np.sort(rng.integers(0, 8192, 1 << 15)).astype(np.int32)
    inside[-1] = 8192  # zero-length runs inside a tile: a huge window
    short = np.sort(rng.integers(0, 20000, 4096)).astype(np.int32)
    return {
        "one_run": (np.arange(5, 261).astype(np.uint8), one, 3 * 8192),
        "zero_length_inside": (rng.integers(0, 256, 1 << 15).astype(
            np.uint8), inside, 8192),
        "ends_short_of_n_pad": (rng.integers(0, 256, 4096).astype(np.uint8),
                                short, 24576),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["straddle", "noise_one_tile", "one_tile"])
def test_rle_decode_kernel_at_tile_edges(cuda_device, name):
    """Runs that straddle the 8 KB tiles, R far above the tile count
    (one tile of one-byte runs), and n_pad of exactly one tile."""
    rng = np.random.default_rng(6)
    arr = {"straddle": np.repeat(rng.integers(0, 256, 4000).astype(np.uint8),
                                 37),
           "noise_one_tile": rng.integers(0, 256, 8192, dtype=np.uint8),
           "one_tile": np.repeat(rng.integers(0, 256, 64).astype(np.uint8),
                                 128)}[name]
    p = W.rle_encode(arr)
    v = torch.from_numpy(p.values).to(cuda_device)
    e = torch.from_numpy(p.ends).to(cuda_device)
    got = W.decode_bytes(v, e, p.n_pad)
    assert torch.equal(got, W.decode_bytes_plain(v, e, p.n_pad))
    assert got.cpu().numpy()[:p.nbytes_raw].tobytes() == arr.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_rle_tables()))
def test_rle_decode_kernel_follows_its_rule_on_any_table(cuda_device, name):
    values, ends, n_pad = _rle_tables()[name]
    got = W.decode_bytes(torch.from_numpy(values).to(cuda_device),
                         torch.from_numpy(ends).to(cuda_device), n_pad)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _upper_bound_decode(values, ends, n_pad))


@pytest.mark.cuda
def test_rle_decode_kernel_one_word_and_out_of_order_ends(cuda_device):
    fn = W._kernel_lib().mmk_rle_decode
    stream = torch.cuda.current_stream().cuda_stream
    # n_pad of one 16-byte word, through the C entry (the wire pads to 128)
    values = np.arange(4, dtype=np.uint8)
    ends = np.array([3, 7, 16, 16], np.int32)
    v = torch.from_numpy(values).to(cuda_device)
    e = torch.from_numpy(ends).to(cuda_device)
    out = torch.empty(16, dtype=torch.uint8, device=cuda_device)
    assert fn(v.data_ptr(), e.data_ptr(), 4, out.data_ptr(), 16, stream) == 0
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  _upper_bound_decode(values, ends, 16))
    # ends out of order: any output, but no fault (every access in bounds)
    rng = np.random.default_rng(7)
    e = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, 1 << 15,
                                      dtype=np.int64).astype(np.int32)
                         ).to(cuda_device)
    v = torch.from_numpy(rng.integers(0, 256, 1 << 15).astype(np.uint8)
                         ).to(cuda_device)
    assert W.decode_bytes(v, e, 1 << 20).numel() == 1 << 20
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_rle_decode_kernel_rejects_what_it_cannot_take(cuda_device):
    p = W.rle_encode(np.zeros(300, np.uint8))
    v = torch.from_numpy(p.values).to(cuda_device)
    e = torch.from_numpy(p.ends).to(cuda_device)
    with pytest.raises(TypeError):
        W.decode_bytes(v, e.to(torch.int64), p.n_pad)
    with pytest.raises(ValueError):
        W.decode_bytes(torch.stack([v, v], 1)[:, 0], e, p.n_pad)  # strided
    with pytest.raises(ValueError):
        W.decode_bytes(v, e.cpu(), p.n_pad)
    # the kernel's vector loads: ends 16-byte, values 4-byte aligned
    e_off = torch.zeros(e.numel() + 1, dtype=torch.int32,
                        device=cuda_device)[1:].copy_(e)
    v_off = torch.zeros(v.numel() + 1, dtype=torch.uint8,
                        device=cuda_device)[1:].copy_(v)
    with pytest.raises(ValueError, match="aligned"):
        W.decode_bytes(v, e_off, p.n_pad)
    with pytest.raises(ValueError, match="aligned"):
        W.decode_bytes(v_off, e, p.n_pad)


# nvJPEG against libjpeg on the fixtures (see the module docstring)
NVJPEG_SAMPLE_MEAN_ABS = 0.089
NVJPEG_CHANNEL_MEAN = 0.0077
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "jpeg_fixtures")


def _jpeg_digests():
    with open(os.path.join(JPEG_FIXTURES, "digests.json")) as f:
        return json.load(f)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_jpeg_digests()["fixtures"]))
def test_native_jpeg_decoder_against_the_fixture_digests(cuda_device, name):
    from mmlspark_tpu_torch import native

    assert native.jpeg_available(), native.build_error()
    d = _jpeg_digests()
    want = d["fixtures"][name]
    with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
        blob = f.read()
    got = native.decode_jpeg_bgr(blob)  # a DecoderError fails the test
    if want is None:  # CMYK: refused; the featurizer falls back to PIL
        assert got is None
        return
    # nvJPEG refuses a progressive stream with a restart interval (fault
    # C3) and an arithmetic-coded one (SOF9), which go to PIL, as
    # decode_image sends them; libjpeg decodes both
    refused = (native.jpeg_backend() == "nvjpeg"
               and name.startswith(("progressive_restart_", "arith_")))
    assert (got is None) == refused, name
    routed = not refused
    if refused:
        from mmlspark_tpu_torch.io.image import decode_image, \
            image_row_to_array

        got = image_row_to_array(decode_image(blob))
    assert list(got.shape) == want["shape"]
    if native.jpeg_backend() == "libjpeg":
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
        return
    k = d["sample_stride"]
    sample = np.frombuffer(base64.b64decode(want["sample"]), np.uint8)
    diff = np.abs(got[::k, ::k].astype(np.int16).ravel()
                  - sample.astype(np.int16))
    channel = ((got.reshape(-1, got.shape[2]).sum(0, np.int64)
                - np.array(want["channel_sums"])) / got[..., 0].size)
    assert diff.mean() <= NVJPEG_SAMPLE_MEAN_ABS, diff.mean()
    assert np.abs(channel).max() <= NVJPEG_CHANNEL_MEAN, channel
    out = np.zeros_like(got)
    assert native.decode_jpeg_bgr_into(blob, out) == routed
    if routed:
        np.testing.assert_array_equal(out, got)


@pytest.mark.cuda
def test_jpeg_featurizer_on_card_matches_its_cpu_run(cuda_device):
    blobs = []
    for n in sorted(os.listdir(JPEG_FIXTURES)):
        if n.startswith("bench_") or n == "cmyk_40x30.jpg":
            with open(os.path.join(JPEG_FIXTURES, n), "rb") as f:
                blobs.append(f.read())
    blobs = blobs * 2 + [b"not an image"]
    state = init_state_dict(get_builder("resnet18")(num_classes=10), seed=0,
                            random_bn=True)
    bundle = TorchBundle("resnet18", {"num_classes": 10}, state_dict=state,
                         input_shape=(64, 64, 3), dtype="float32")
    table = Table({"image": blobs, "id": np.arange(len(blobs))})
    K.LAUNCHES = 0
    got = ImageFeaturizer(bundle=bundle, batch_size=3).transform(table)
    # the three fixture sizes and the CMYK 40x30 (by PIL or dropped),
    # chunks of 3: 256^2 (4 rows) 2, 224^2 2, 320x240 2, 40x30 1
    ref = ImageFeaturizer(bundle=bundle, batch_size=3,
                          device="cpu").transform(table)
    np.testing.assert_array_equal(got["id"], ref["id"])
    assert got["features"].shape[1] == 512 and 12 <= got.num_rows <= 14
    assert K.LAUNCHES == 6 + (got.num_rows > 12)
    scale = float(np.abs(ref["features"]).max())
    np.testing.assert_allclose(got["features"], ref["features"], rtol=1e-3,
                               atol=1e-3 * scale)


@pytest.mark.cuda
def test_unroll_image_transform_launches_the_kernel_once(cuda_device):
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
              for _ in range(5)]
    table = Table({"image": images})
    K.LAUNCHES_UNROLL = 0
    got = S.UnrollImage(mean=list(IMAGENET_MEAN_BGR),
                        std=list(IMAGENET_STD_BGR)).transform(table)
    assert K.LAUNCHES_UNROLL == 1  # one shape group
    ref = S.UnrollImage(mean=list(IMAGENET_MEAN_BGR),
                        std=list(IMAGENET_STD_BGR),
                        device="cpu").transform(table)
    for a, b in zip(got["unrolled"], ref["unrolled"]):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_compressed_put_group_launches_the_decode_per_chunk(cuda_device):
    chunks = _feed_bench_chunks(4)
    tel = FeedTelemetry()
    W.LAUNCHES = 0
    outs = DeviceFeed(cuda_device, telemetry=tel).put_group(
        [W.rle_encode(c) for c in chunks])
    torch.cuda.synchronize()
    assert W.LAUNCHES == len(chunks)
    for c, o in zip(chunks, outs):
        assert o.device.type == "cuda" and o.dtype == torch.uint8
        np.testing.assert_array_equal(o.cpu().numpy(), c)
    snap = tel.snapshot()
    assert snap["compressed_groups"] == 1 and snap["transfer_calls"] == 1
    assert snap["wire_bytes_raw"] == sum(c.nbytes for c in chunks)
    assert snap["wire_bytes_sent"] == sum(
        W.rle_encode(c).wire_nbytes for c in chunks)


# B8 on the split kernel: int8 pools from quantize_kv_row of f32 pools
# (the serving shape with bf16 and f32 q, GQA at 3 and 8 query heads a
# K/V head, D 32 with 16-row pages, D 36 whose int8 rows are not whole
# 16-byte vectors, D 256), against its plain version and the split
# arithmetic's PyTorch mirror at 1e-4.
B8_CASES = [  # (b, h, hkv, d, page, mp, q dtype, positions)
    (8, 12, 12, 64, 64, 16, torch.bfloat16,
     [0, 63, 64, 1023, 500, 129, 900, 7]),
    (8, 12, 12, 64, 64, 16, torch.float32,
     [0, 63, 64, 1023, 500, 129, 900, 7]),
    (4, 12, 4, 64, 64, 16, torch.bfloat16, [5, 700, 64, 1000]),
    (4, 16, 2, 64, 64, 16, torch.bfloat16, [0, 63, 64, 1023]),
    (3, 4, 4, 32, 16, 8, torch.float32, [0, 17, 127]),
    (3, 6, 6, 36, 16, 8, torch.bfloat16, [5, 0, 127]),
    (3, 6, 2, 36, 16, 8, torch.float32, [16, 0, 127]),
    (2, 8, 1, 256, 32, 8, torch.bfloat16, [3, 255]),
]


def _int8_inputs(device, case, seed):
    b, h, hkv, d, page, mp, dtype, positions = case
    q, k, v, table, pos = _paged_inputs(device, b, h, hkv, d, page, mp,
                                        dtype, positions, seed)
    kq, ks = quantize_kv_row(k.float())
    vq, vs = quantize_kv_row(v.float())
    return q, (kq, ks, vq, vs), table, pos


@pytest.mark.cuda
@pytest.mark.parametrize("case", B8_CASES)
def test_split_merge_b8_matches_plain_on_card(cuda_device, case):
    q, pools, table, pos = _int8_inputs(cuda_device, case, seed=12)
    before = PA.LAUNCHES_INT8
    got = PA.paged_decode_attention_int8(q, *pools, table, pos)
    again = PA.paged_decode_attention_int8(q, *pools, table, pos)
    torch.cuda.synchronize()
    assert PA.LAUNCHES_INT8 == before + 2  # one a call: split and merge
    assert torch.equal(got, again)  # bit-identical reruns
    for ref in (PA.paged_decode_attention_int8_plain(q, *pools, table, pos),
                PA.paged_decode_attention_int8_split_plain(q, *pools, table,
                                                           pos)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_split_merge_b8_never_reads_past_the_live_pages(cuda_device):
    """Every page no slot's live rows reach (page 0, which the unused
    table entries point at, and the pages past each slot's last live
    one) holds NaN scales and codes of 127: none reaches the output."""
    case = (4, 12, 12, 64, 64, 16, torch.bfloat16, [0, 70, 1023, 5])
    q, (kq, ks, vq, vs), table, pos = _int8_inputs(cuda_device, case,
                                                   seed=13)
    ref = PA.paged_decode_attention_int8_plain(q, kq, ks, vq, vs, table, pos)
    live = set()
    for row, p in zip(table.cpu().numpy(), pos.cpu().numpy()):
        live.update(row[:p // 64 + 1].tolist())
    dead = [i for i in range(kq.shape[0]) if i not in live]
    assert 0 in dead and (table == 0).any()
    for t in (kq, vq):
        t[dead] = 127
    for t in (ks, vs):
        t[dead] = float("nan")
    got = PA.paged_decode_attention_int8(q, kq, ks, vq, vs, table, pos)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_split_merge_b8_never_syncs_with_the_host(cuda_device):
    q, pools, table, pos = _int8_inputs(cuda_device, B8_CASES[0], seed=14)
    PA.paged_decode_attention_int8(q, *pools, table, pos)  # builds, loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = PA.paged_decode_attention_int8(q, *pools, table, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_b8_rejects_what_it_cannot_take(cuda_device):
    q, (kq, ks, vq, vs), table, pos = _int8_inputs(
        cuda_device, (2, 4, 4, 64, 16, 4, torch.float32, [3, 40]), seed=15)
    with pytest.raises(TypeError):                      # int32 q
        PA.paged_decode_attention_int8(q.to(torch.int32), kq, ks, vq, vs,
                                       table, pos)
    with pytest.raises(TypeError):                      # f32 pools
        PA.paged_decode_attention_int8(q, kq.float(), ks, vq.float(), vs,
                                       table, pos)
    with pytest.raises(TypeError):                      # f64 scales
        PA.paged_decode_attention_int8(q, kq, ks.double(), vq, vs, table,
                                       pos)
    with pytest.raises(TypeError):                      # int64 positions
        PA.paged_decode_attention_int8(q, kq, ks, vq, vs, table, pos.long())
    with pytest.raises(ValueError):                     # D % 4
        PA.paged_decode_attention_int8(
            q[..., :62].contiguous(), kq[..., :62].contiguous(), ks,
            vq[..., :62].contiguous(), vs, table, pos)


# B1 on both routes: the rule's route through the wrapper and the pixel
# route (`_launch` with TY 0) on the same inputs, against the plain
# version at 1e-3 (normalized units): the featurizers' three chunk
# shapes, a large odd one, an f32 gray upscale, ragged store edges (rows
# of 7 x 31 x 4 and 7 x 31 x 3 values), DeepVisionClassifier's batch, and
# plans the rule sends to the pixel route.
B1_CASES = [  # (dtype, shape, out_hw)
    ("uint8", (64, 256, 256, 3), (224, 224)),
    ("uint8", (64, 224, 224, 3), (224, 224)),
    ("uint8", (64, 320, 240, 3), (224, 224)),
    ("uint8", (7, 333, 517, 3), (224, 224)),
    ("float32", (5, 97, 131, 1), (224, 224)),
    ("uint8", (2, 19, 23, 4), (7, 31)),
    ("float32", (3, 19, 23, 3), (7, 31)),
    ("uint8", (256, 32, 32, 3), (32, 32)),
    ("uint8", (2, 1500, 2000, 3), (224, 224)),
    ("float32", (2, 600, 1600, 3), (224, 224)),
]


def _b1_check(device, x, plan, want_route):
    assert plan.route[str(x.dtype)[6:]] == want_route
    ty, _span = plan.tiling(x.dtype, x.shape[0])
    assert (ty > 0) == (want_route == "tile")
    before = K.LAUNCHES
    got = K.affine_resample(x, plan)
    pixel = K._launch(x, plan, 0, 0)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    ref = K.affine_resample_plain(x, plan).cpu().numpy()
    for out in (got, pixel):
        np.testing.assert_allclose(out.cpu().numpy(), ref, atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,out_hw", B1_CASES)
def test_b1_both_routes_match_plain_on_card(cuda_device, dtype, shape,
                                            out_hw):
    rng = np.random.default_rng(21)
    if dtype == "uint8":
        x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    else:
        x = rng.uniform(0, 255, size=shape).astype(np.float32)
    c = shape[3]
    plan = K.resize_plan(shape[1], shape[2], c, *out_hw,
                         (IMAGENET_MEAN_BGR * 2)[:c], (IMAGENET_STD_BGR * 2)[:c])
    route = "pixel" if shape[1] >= 600 else "tile"
    _b1_check(cuda_device, torch.from_numpy(x).to(cuda_device), plan, route)


@pytest.mark.cuda
def test_b1_flip_crop_chain_matches_plain_on_card(cuda_device):
    stages = [("crop", {"x": 40, "y": 21, "height": 300, "width": 400}),
              ("resize", {"height": 224, "width": 224}),
              ("blur", {"height": 2.0, "width": 2.0}),
              ("flip", {"flipLeftRight": True, "flipUpDown": True})]
    plan = K.affine_plan(K.freeze_stages(stages), 333, 517, 3)
    x = np.random.default_rng(22).integers(0, 256, (16, 333, 517, 3),
                                           dtype=np.uint8)
    _b1_check(cuda_device, torch.from_numpy(x).to(cuda_device), plan, "tile")


@pytest.mark.cuda
def test_b1_rejects_what_it_cannot_take(cuda_device):
    plan = K.resize_plan(8, 8, 3, 4, 4, (0.0,) * 3, (1.0,) * 3)
    x = torch.zeros(2, 8, 8, 3, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError):                      # f64
        K.affine_resample(x.double(), plan)
    with pytest.raises(ValueError):                     # strided batch
        K.affine_resample(x.transpose(1, 2), plan)
    with pytest.raises(ValueError):                     # shape != plan
        K.affine_resample(x[:, :7].contiguous(), plan)
    wide = K.AffinePlan(np.eye(8), np.eye(8), np.eye(5), np.zeros(5),
                        np.ones(5))
    with pytest.raises(ValueError):                     # > 4 channels
        K.affine_resample(torch.zeros(2, 8, 8, 5, dtype=torch.uint8,
                                      device=cuda_device), wide)


def _pil_jpeg(shape, subsampling, seed):
    import io

    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, shape).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=85,
                              subsampling=subsampling)
    return buf.getvalue()


def _ycc_blobs():
    blobs = {n: open(os.path.join(JPEG_FIXTURES, n), "rb").read()
             for n in sorted(_jpeg_digests()["fixtures"])}
    for ss in (0, 1, 2):
        for i, hw in enumerate([(17, 23), (3, 5), (33, 17), (9, 2)]):
            blobs[f"pil_ss{ss}_{hw[0]}x{hw[1]}"] = _pil_jpeg(hw + (3,), ss, i)
    return blobs


@pytest.mark.cuda
def test_c2_kernel_equals_its_plain_version_and_the_decode(cuda_device):
    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.ops.jpeg_color import ycc_to_bgr, ycc_to_bgr_plain

    if native.jpeg_backend() != "nvjpeg":
        pytest.skip("the C2 kernel is the nvJPEG decoder's")
    checked = 0
    for name, blob in _ycc_blobs().items():
        got = native.decode_jpeg_planes(blob)
        if got is None or len(got[1]) != 3:
            continue
        layout, planes = got
        args = ([torch.from_numpy(p).to(cuda_device) for p in planes],
                layout.factors, layout.height, layout.width, layout.color)
        n0 = native.ycc_launches()
        kern = ycc_to_bgr(*args)
        torch.cuda.synchronize()
        assert native.ycc_launches() == n0 + 1
        assert torch.equal(kern, ycc_to_bgr_plain(*args)), name
        decoded = native.decode_jpeg_bgr(blob)
        assert native.ycc_launches() == n0 + 2
        np.testing.assert_array_equal(kern.cpu().numpy(), decoded,
                                      err_msg=name)
        checked += 1
    # the six bench fixtures, the progressive one and the two with restart
    # intervals (the progressive one with restarts is refused, C3), and
    # the twelve odd-size streams
    assert checked == 9 + 12
    with pytest.raises(ValueError, match="expected"):
        ycc_to_bgr(args[0][:2] + [args[0][0]], layout.factors, layout.height,
                   layout.width, layout.color)


@pytest.mark.cuda
def test_nvjpeg_route_on_odd_sizes_is_within_the_limits_of_pil(cuda_device):
    """PIL decodes with libjpeg-turbo's own upsampling and conversion: on
    4:4:4, 4:2:2 and 4:2:0 images of odd sizes the nvJPEG route differs
    from it only by the IDCT."""
    from PIL import Image
    import io

    from mmlspark_tpu_torch import native

    for name, blob in _ycc_blobs().items():
        if not name.startswith("pil_"):
            continue
        got = native.decode_jpeg_bgr(blob)
        pil = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))[
            :, :, ::-1]
        assert got.shape == pil.shape, name
        diff = np.abs(got.astype(np.int16) - pil.astype(np.int16))
        assert diff.max() <= 3 and diff.mean() <= 0.2, (name, diff.max(),
                                                         diff.mean())


@pytest.mark.cuda
def test_progressive_streams_with_restarts_are_refused_to_pil(cuda_device):
    """Fault C3: nvJPEG decoded a progressive stream whose scans carry
    restart markers into wrong pixels without an error (on noise with a
    restart every 2 MCUs, far past the IDCT's differences, on an H100
    80GB HBM3 at 700 W).  The nvJPEG backend refuses such streams, so
    decode_image takes PIL's pixels; every other stream kind decodes
    within the odd-size limits of PIL (max 3, mean 0.2), and no stream
    raises."""
    from PIL import Image
    import io

    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.io.image import decode_image, image_row_to_array

    kinds = {"restart": {"restart_marker_blocks": 3},
             "restart_rows": {"restart_marker_rows": 1},
             "progressive": {"progressive": True},
             "progressive_restart": {"progressive": True,
                                     "restart_marker_blocks": 2},
             "progressive_restart_rows": {"progressive": True,
                                          "restart_marker_rows": 1}}
    rng = np.random.default_rng(11)
    # (PIL 12.2 fails to write a progressive stream with restarts at
    # 224x224; the committed 256x256 fixture covers a bench size)
    for hw in ((61, 45), (64, 48)):
        arr = rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
        for kind, kw in kinds.items():
            for ss in (0, 2):
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="JPEG", quality=85,
                                          subsampling=ss, **kw)
                blob = buf.getvalue()
                pil = np.asarray(Image.open(io.BytesIO(blob)).convert(
                    "RGB"))[:, :, ::-1]
                got = native.decode_jpeg_bgr(blob)
                refused = (native.jpeg_backend() == "nvjpeg"
                           and kind.startswith("progressive_restart"))
                assert (got is None) == refused, (hw, kind, ss)
                for out in ([got] if got is not None else []) + [
                        image_row_to_array(decode_image(blob))]:
                    diff = np.abs(out.astype(np.int16) - pil.astype(np.int16))
                    assert diff.max() <= 3 and diff.mean() <= 0.2, (
                        hw, kind, ss, diff.max(), diff.mean())


@pytest.mark.cuda
def test_frames_other_than_8_bit_huffman_dct_are_refused(cuda_device):
    """The nvJPEG route takes only SOF0, SOF1 and SOF2 frames of 8-bit
    precision.  A committed baseline fixture with its SOF marker
    rewritten to a lossless, hierarchical or arithmetic-coded frame, or
    its precision byte to 12, is refused (None) and never raises
    `DecoderError`, and `safe_read` hands it to PIL; rewritten to SOF1
    (extended sequential, the same Huffman data) it decodes to the
    baseline's pixels.  A real arithmetic-coded stream (the committed
    SOF9 fixture) is refused too, and decode_image gives PIL's pixels,
    within PIL's odd-size limits of the libjpeg digest."""
    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.io.image import (decode_image,
                                             image_row_to_array, safe_read)

    assert native.jpeg_available(), native.build_error()
    nvjpeg = native.jpeg_backend() == "nvjpeg"
    with open(os.path.join(JPEG_FIXTURES, "bench_1_224x224.jpg"), "rb") as f:
        blob = f.read()
    sof = blob.find(b"\xff\xc0")
    assert sof > 0 and blob[sof + 4] == 8
    base = native.decode_jpeg_bgr(blob)
    for marker in (0xC1, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
                   0xCE, 0xCF):
        bad = bytearray(blob)
        bad[sof + 1] = marker
        got = native.decode_jpeg_bgr(bytes(bad))  # DecoderError fails it
        if marker == 0xC1:  # kept (nvJPEG may still refuse it itself)
            if got is not None:
                np.testing.assert_array_equal(got, base)
        elif nvjpeg:
            assert got is None, hex(marker)
        safe_read(bytes(bad))  # PIL's pixels or None, never DecoderError
    for precision in (12, 16):
        bad = bytearray(blob)
        bad[sof + 4] = precision
        if nvjpeg:
            assert native.decode_jpeg_bgr(bytes(bad)) is None, precision
        safe_read(bytes(bad))
    with open(os.path.join(JPEG_FIXTURES, "arith_224x224.jpg"), "rb") as f:
        arith = f.read()
    assert arith.find(b"\xff\xc9") > 0
    if nvjpeg:
        assert native.decode_jpeg_bgr(arith) is None
        assert native.decode_jpeg_planes(arith) is None
    want = _jpeg_digests()["fixtures"]["arith_224x224.jpg"]
    got = image_row_to_array(decode_image(arith))
    assert list(got.shape) == want["shape"]
    assert np.abs(got.reshape(-1, 3).sum(0, np.int64)
                  - np.array(want["channel_sums"])).max() / got[..., 0].size \
        <= NVJPEG_CHANNEL_MEAN


def _cuda_train_state(cuda_device, opt):
    from mmlspark_tpu_torch.models import training as TR
    from mmlspark_tpu_torch.models.resnet import resnet18

    factory = TR.sgd(0.1, 0.9) if opt == "sgd" else TR.adam(1e-3)
    return TR.init_train_state(resnet18(num_classes=10), factory, seed=0,
                               compute_dtype="bfloat16")


def _numbers(state):
    out = {f"m/{k}": v.detach().cpu().clone()
           for k, v in state.module.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"o/{i}/{k}"] = v.detach().cpu().clone()
    for i, p in enumerate(state.work.parameters()):
        out[f"w/{i}"] = p.detach().cpu().clone()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_cuda_train_state_round_trips_a_checkpoint(cuda_device, tmp_path,
                                                   opt):
    from mmlspark_tpu_torch.models import training as TR
    from mmlspark_tpu_torch.models.checkpoint import CheckpointManager

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((3, 16, 32, 32, 3), device="cuda", generator=gen)
    y = torch.randint(0, 10, (3, 16), device="cuda", generator=gen)
    step = TR.make_train_step(10)
    state = _cuda_train_state(cuda_device, opt)
    for i in range(2):
        state, _ = step(state, x[i], y[i])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=2)
    saved = _numbers(state)
    # a poisoned step writes NaN into the live state in place
    state, m = step(state, torch.full_like(x[2], float("nan")), y[2])
    assert not np.isfinite(float(m["loss"]))
    restored = mgr.restore(step=2, template=state)
    got = _numbers(restored)
    assert sorted(got) == sorted(saved)
    for k in saved:
        assert torch.equal(got[k], saved[k]), k
    assert restored.device.type == "cuda" and restored.step == 2
    # and it continues as the saved state does
    fresh = mgr.restore(step=2, template=_cuda_train_state(cuda_device, opt))
    torch.backends.cudnn.deterministic = True
    try:
        _, m1 = step(restored, x[2], y[2])
        _, m2 = step(fresh, x[2], y[2])
    finally:
        torch.backends.cudnn.deterministic = False
    assert float(m1["loss"]) == float(m2["loss"])


@pytest.mark.cuda
def test_a_device_failure_in_the_decoder_raises(cuda_device, monkeypatch):
    """A failure of the card in a decode is the decoder's, not the
    stream's: with the card's memory taken, a decode that needs larger
    device buffers raises DecoderError from decode_image and from the
    featurizer's JPEG path, and no row is decoded by PIL instead; with
    the memory given back, the same bytes decode."""
    from PIL import Image
    import io

    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.io.image import decode_image

    if native.jpeg_backend() != "nvjpeg":
        pytest.skip("the device buffers are the nvJPEG decoder's")

    def jpeg(h, w):
        y, x = np.mgrid[0:h, 0:w]
        arr = np.stack([x % 256, y % 256, (x + y) % 256], -1).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=85)
        return buf.getvalue()

    small, big = jpeg(48, 40), jpeg(6000, 6000)  # big: 108 MB of BGR
    state = init_state_dict(get_builder("resnet18")(num_classes=10), seed=0)
    bundle = TorchBundle("resnet18", {"num_classes": 10}, state_dict=state,
                         input_shape=(64, 64, 3), dtype="float32")
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=2)
    # the handle, a slot and the model are on the card before the memory
    # is taken
    assert featurizer.transform(Table({"image": [small] * 2})).num_rows == 2
    monkeypatch.setattr(Image, "open",
                        lambda *a, **k: pytest.fail("decoded by PIL"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    hog = torch.empty(free - (64 << 20), dtype=torch.uint8, device="cuda")
    try:
        with pytest.raises(native.DecoderError, match="code -5"):
            decode_image(big)
        with pytest.raises(native.DecoderError, match="code -5"):
            featurizer.transform(Table({"image": [big, big]}))
    finally:
        del hog
        torch.cuda.empty_cache()
    monkeypatch.undo()
    got = native.decode_jpeg_bgr(big)
    pil = np.asarray(Image.open(io.BytesIO(big)).convert("RGB"))[:, :, ::-1]
    assert got.shape == pil.shape
    assert np.abs(got.astype(np.int16) - pil.astype(np.int16)).max() <= 3


# ---- int8 weight inference (ops/quant.py) and stage persistence -----------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [((1, 24), 40), ((5, 20), 13),
                                     ((2, 3, 64), 72), ((256, 768), 2304)])
def test_int8_matmul_on_card_equals_the_cpu_bit_for_bit(cuda_device, shape,
                                                         n):
    """torch._int_mm wants M > 16 and K, N multiples of 8: the wrapper pads
    with zeros, which changes no real output, so the card gives the CPU's
    bits (the quantization is the same f32 arithmetic on both)."""
    from mmlspark_tpu_torch.ops import quant as Q

    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, shape[-1])) * 0.1)
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    want = Q.int8_dense(x, w, b)
    Q.INT8_GEMMS = 0
    got = Q.int8_dense(x.to(cuda_device), w.to(cuda_device), b.to(cuda_device))
    assert Q.INT8_GEMMS == 1
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_quant_linear_on_card_runs_no_float_matmul(cuda_device, monkeypatch):
    from mmlspark_tpu_torch.ops import quant as Q

    layer = Q.QuantLinear(64, 48).to(device=cuda_device, dtype=torch.bfloat16)
    assert layer.weight.dtype == torch.float32
    x = torch.randn(3, 64, device=cuda_device, dtype=torch.bfloat16)
    for fn in ("linear",):
        monkeypatch.setattr(torch.nn.functional, fn,
                            lambda *a, **k: pytest.fail("a float matmul"))
    monkeypatch.setattr(torch, "matmul",
                        lambda *a, **k: pytest.fail("a float matmul"))
    Q.INT8_GEMMS = 0
    for prequantized in (False, True):
        if prequantized:
            Q.prequantize(layer)
        y = layer(x)
        assert y.dtype == torch.bfloat16 and y.shape == (3, 48)
    assert Q.INT8_GEMMS == 2


@pytest.mark.cuda
def test_quant_lm_generate_on_card_matches_the_cpu(cuda_device):
    """A 2-layer f32 TransformerLM with quant=True, prequantized: greedy
    tokens on the card equal the CPU's (attention is the flash kernel on
    the card, its plain version on the CPU, so an activation may round to
    a neighbouring int8 level; random weights give no near-ties here)."""
    from mmlspark_tpu_torch.models.bundle import prequantize

    kw = dict(vocab_size=256, embed_dim=128, num_layers=2, num_heads=2,
              max_len=64, quant=True)
    bundle = prequantize(TorchBundle("transformer_lm", kw, input_shape=(16,),
                                     dtype="float32", seed=3))
    prompt = np.random.default_rng(4).integers(0, 256, (2, 16)).astype(
        np.int32)
    got = generate(bundle, prompt, 8)
    want = generate(bundle, prompt, 8, device="cpu")
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_a_loaded_torch_model_on_card_equals_the_unsaved_one(cuda_device,
                                                             tmp_path):
    from mmlspark_tpu_torch.core.pipeline import PipelineStage
    from mmlspark_tpu_torch.models import torch_model as TM

    state = init_state_dict(get_builder("resnet18")(num_classes=10), seed=0,
                            random_bn=True)
    bundle = TorchBundle("resnet18", {"num_classes": 10}, state_dict=state,
                         input_shape=(64, 64, 3))
    x = np.random.default_rng(5).integers(0, 256, (6, 64, 64, 3)).astype(
        np.uint8)
    stage = TM.TorchModel(bundle=bundle, input_col="x", fetch_node="pool",
                          batch_size=4, feed_dtype="uint8",
                          preprocess=TM.ImagePreprocess(64, 64))
    table = Table({"x": x})
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        want = stage.transform(table)["output"]
        stage.save(str(tmp_path / "m"))
        TM._EXEC_CACHE.clear()
        loaded = PipelineStage.load(str(tmp_path / "m"))
        K.LAUNCHES = 0
        got = loaded.transform(table)["output"]
    assert K.LAUNCHES == 2  # B1 once per chunk of the loaded stage
    np.testing.assert_array_equal(got, want)


# ---- the GBDT engine: no kernel of its own (stock PyTorch scatter-adds,
# cumsums and gathers on the card), held to its CPU run ---------------------

def _gbdt_node(n, seed, share=0.7):
    rng = np.random.default_rng(seed)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.1, 0.3, size=n).astype(np.float32)
    w = (rng.random(n) < 0.9).astype(np.float32)
    return grad, hess, w, rng.random(n) < share


def _mass_err(got, want):
    """Largest difference relative to the node's absolute mass, channel by
    channel (tests/torch_gbdt_compare.py)."""
    from torch_gbdt_compare import hist_err

    return hist_err(got.cpu().double().numpy(), want.cpu().double().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b", [(200_000, 28, 256), (4096, 300, 64),
                                   (48, 1 << 18, 16)])
def test_gbdt_dense_histogram_on_card_matches_the_cpu(cuda_device, n, f, b):
    from mmlspark_tpu_torch.gbdt import histogram as H

    binned = np.random.default_rng(n).integers(0, b, (n, f)).astype(np.uint8)
    arrays = (binned,) + _gbdt_node(n, seed=f)
    want = H.build_histogram(*map(torch.as_tensor, arrays), b)
    got = H.build_histogram(*(torch.as_tensor(a, device=cuda_device)
                              for a in arrays), b)
    assert got.shape == (f, b, 3) and got.device.type == "cuda"
    assert _mass_err(got, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,max_bin", [(20_000, 64, 63), (5000, 3000, 15),
                                         (3000, 1 << 18, 15)])
def test_gbdt_coo_histogram_on_card_matches_the_cpu(cuda_device, n, f,
                                                    max_bin):
    from mmlspark_tpu_torch.gbdt import sparse as SP

    rng = np.random.default_rng(f)
    nnz = 12 * n
    rows = np.sort(rng.integers(0, n, nnz))
    cols = rng.integers(0, min(f, 5000), nnz) * (f // min(f, 5000))
    keys = np.unique(rows * f + cols)
    rows, cols = keys // f, keys % f
    indptr = np.searchsorted(rows, np.arange(n + 1))
    csr = SP.CSRMatrix(rng.normal(size=len(keys)), cols, indptr, (n, f))
    view = SP.SparseBinMapper(max_bin).fit_transform(csr)
    arrays = (view.feat_nz, view.bin_nz, view.row_nz, view.zero_bins) + \
        _gbdt_node(n, seed=n)
    want = SP.build_histogram_coo(*map(torch.as_tensor, arrays),
                                  max_bin + 1, f)
    got = SP.build_histogram_coo(*(torch.as_tensor(a, device=cuda_device)
                                   for a in arrays), max_bin + 1, f)
    assert got.shape == (f, max_bin + 1, 3) and got.device.type == "cuda"
    assert _mass_err(got, want) <= 1e-4


@pytest.mark.cuda
def test_gbdt_two_builds_of_one_node_on_card(cuda_device):
    """The same node built twice on the card: equal within 1e-4 of its
    mass; whether bit for bit is printed (index_add_ adds with atomics)."""
    from mmlspark_tpu_torch.gbdt import histogram as H

    n, f, b = 500_000, 28, 256
    binned = np.random.default_rng(3).integers(0, b, (n, f)).astype(np.uint8)
    builder = H.HistogramBuilder(binned, b, device="cuda")
    grad, hess, w, mask = _gbdt_node(n, seed=4)
    arrs = builder.device_arrays(grad, hess, w)
    first = builder.build(*arrs, builder.node_mask(mask))
    second = builder.build(*arrs, builder.node_mask(mask))
    assert _mass_err(second, first.cpu()) <= 1e-4
    print(f"two card builds of one node bitwise equal: "
          f"{bool(torch.equal(first, second))}, max diff "
          f"{float((first - second).abs().max()):.3g}")


@pytest.mark.cuda
def test_gbdt_predict_forest_on_card_matches_the_host_traversal(cuda_device):
    from mmlspark_tpu_torch.gbdt import Booster, TrainConfig

    rng = np.random.default_rng(6)
    x = rng.normal(size=(3000, 8))
    y = 3 * x[:, 0] + np.sin(2 * x[:, 1]) + 0.1 * rng.normal(size=3000)
    b = Booster(TrainConfig(num_iterations=12, num_leaves=15,
                            min_data_in_leaf=5)).fit(x, y, device="cpu")
    xt = rng.normal(size=(5000, 8))
    xt[::9, 3] = np.nan                      # NaN goes left
    got = b.raw_scores_jit(xt, device="cuda")
    np.testing.assert_allclose(got, b._raw_scores(xt), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, b.raw_scores_jit(xt, device="cpu"),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("boosting", ["gbdt", "goss"])
def test_gbdt_fit_on_card_matches_the_cpu_fit(cuda_device, boosting):
    """A booster fit on the card against the same fit on the CPU by the tie
    rule of tests/torch_gbdt_compare.py; the estimator's default device is
    the card."""
    from mmlspark_tpu_torch.gbdt import (Booster, GBDTClassifier,
                                         TrainConfig, tree as T)
    from torch_gbdt_compare import (compare_fits, following_splits,
                                    recorded_splits)

    rng = np.random.default_rng(7)
    x = rng.normal(size=(20_000, 10))
    y = (x[:, 0] * 2 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
         + rng.normal(scale=0.5, size=20_000) > 0).astype(np.float64)
    cfg = dict(objective="binary", num_iterations=8, num_leaves=31,
               boosting_type=boosting)
    with recorded_splits(T) as calls:
        cpu = Booster(TrainConfig(**cfg)).fit(x, y, device="cpu")
    with following_splits(T, calls, f"card {boosting}",
                          cpu.trees if boosting == "goss" else None):
        card = Booster(TrainConfig(**cfg)).fit(x, y, device="cuda")
    compare_fits(cpu, card, label=f"card {boosting}")
    model = GBDTClassifier(num_iterations=3).fit(Table({"features": x,
                                                        "label": y}))
    assert model.booster.config.num_iterations == 3


# ---- the classic-ML slice: the linear learners and the host library -------

def _standard_cls(n, d, classes, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x[:, :classes] * 2 + 0.5 * rng.normal(size=(n, classes))).argmax(1)
    return Table({"features": x, "label": y.astype(np.float64)})


def _close_fits(cpu, card, w_rtol, s_atol, table):
    scale = np.abs(cpu.weights["w"]).max()
    for k in ("w", "b"):
        assert card.weights[k].dtype == cpu.weights[k].dtype
        assert np.abs(card.weights[k] - cpu.weights[k]).max() <= \
            w_rtol * scale, k
    a, b = cpu.transform(table), card.transform(table)
    np.testing.assert_allclose(b["scores"], a["scores"], rtol=0, atol=s_atol)
    top2 = np.sort(a["scores"], axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] >= 1e-3
    np.testing.assert_array_equal(np.asarray(b["prediction"])[sure],
                                  np.asarray(a["prediction"])[sure])


@pytest.mark.cuda
@pytest.mark.parametrize("classes,steps", [(2, 200), (5, 60)])
def test_logistic_regression_on_card_matches_the_cpu(cuda_device, classes,
                                                     steps):
    """The card's fit (the default device) against the CPU's at the CPU
    parity test's tolerances (tests/test_torch_linear.py): weights within
    1e-4 of max |w|, scores within 1e-5."""
    from mmlspark_tpu_torch.models.linear import LogisticRegression

    t = _standard_cls(4000, 32, classes, seed=classes)
    card = LogisticRegression(max_iter=steps).fit(t)
    cpu = LogisticRegression(max_iter=steps, device="cpu").fit(t)
    assert card.device is None and cpu.device == "cpu"
    _close_fits(cpu, card, 1e-4, 1e-5, _standard_cls(1000, 32, classes, 9))


@pytest.mark.cuda
def test_learners_ignore_the_process_tf32_setting(cuda_device):
    """A process with TF32 on gets the same fit as one with it off: the
    learners run their f32 products at full precision."""
    from mmlspark_tpu_torch.models.linear import LogisticRegression

    t = _standard_cls(4000, 64, 3, seed=11)
    fits = []
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            fits.append(LogisticRegression(max_iter=100).fit(t))
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    _close_fits(fits[0], fits[1], 1e-6, 1e-6, t)


@pytest.mark.cuda
def test_linear_regression_on_card_matches_the_cpu(cuda_device):
    """The f64 ridge solved on the card against the CPU's: weights within
    1e-9 of max |w| on a full-rank table."""
    from mmlspark_tpu_torch.models.linear import LinearRegression

    rng = np.random.default_rng(12)
    x = rng.normal(size=(20_000, 50)).astype(np.float32)
    y = x @ rng.normal(size=50) + 0.1 * rng.normal(size=20_000)
    t = Table({"features": x, "label": y})
    card = LinearRegression().fit(t)
    cpu = LinearRegression(device="cpu").fit(t)
    scale = np.abs(cpu.weights["w"]).max()
    for k in ("w", "b"):
        assert np.abs(card.weights[k] - cpu.weights[k]).max() <= 1e-9 * scale
    np.testing.assert_allclose(card.transform(t)["prediction"],
                               cpu.transform(t)["prediction"], rtol=1e-9,
                               atol=1e-9)


@pytest.mark.cuda
def test_train_classifier_runs_on_the_card_by_default(cuda_device):
    from mmlspark_tpu_torch.models.train_classifier import (TrainClassifier,
                                                            TrainRegressor)

    rng = np.random.default_rng(13)
    n = 3000
    cols = {"a": rng.normal(size=n), "cat": rng.choice(["x", "y", "z"], n)}
    cols["label"] = np.where(cols["a"] + (cols["cat"] == "x") > 0.5, "yes",
                             "no").astype(object)
    t = Table(cols)
    card = TrainClassifier().fit(t)
    cpu = TrainClassifier(device="cpu").fit(t)
    assert card.inner_model.device is None
    _close_fits(cpu.inner_model, card.inner_model, 1e-4, 1e-5,
                cpu.featurizer.transform(t))
    assert list(card.transform(t)["prediction"][:5]) == \
        list(cpu.transform(t)["prediction"][:5])
    reg = Table({"a": cols["a"], "cat": cols["cat"],
                 "label": 2 * cols["a"] + (cols["cat"] == "z")})
    p_card = TrainRegressor().fit(reg).transform(reg)["prediction"]
    p_cpu = TrainRegressor(device="cpu").fit(reg).transform(reg)["prediction"]
    np.testing.assert_allclose(p_card, p_cpu, rtol=0, atol=1e-8)


@pytest.mark.cuda
def test_the_host_library_builds_on_the_cards_machine(cuda_device, tmp_path):
    """native/src/host.cpp builds with that machine's g++ (no jpeglib.h
    there) and its entries equal their plain versions."""
    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.io.binary import read_csv

    native.host_library()
    s = [f"w{i}" for i in range(5000)] + ["", "naïve"]
    np.testing.assert_array_equal(native.murmur3_batch(s, 7),
                                  native.murmur3_batch_plain(s, 7))
    rng = np.random.default_rng(14)
    b = rng.integers(0, 32, (3000, 5)).astype(np.uint8)
    g, h = rng.normal(size=3000), rng.uniform(size=3000)
    node = rng.integers(-1, 3, 3000)
    np.testing.assert_array_equal(native.histogram(b, g, h, node, 3, 32),
                                  native.histogram_plain(b, g, h, node, 3, 32))
    x = rng.normal(size=(100, 3))
    x[5, 1] = np.nan
    path = str(tmp_path / "x.csv")
    np.savetxt(path, x, delimiter=",", header="a,b,c", comments="",
               fmt="%.17g")
    np.testing.assert_array_equal(read_csv(path)["b"], x[:, 1])


# --- the rest of classic ML: K1 (the online learners' pass), Word2Vec,
# KNN, SAR, the isolation forest, the tagger and a convnet featurizer

def _k1_rows(n, a, dim, seed):
    """Rows with duplicated indices, explicit zeros, all-zero rows."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(n, a))
    idx[::3, 1] = idx[::3, 0]
    idx[::5, 2 % a] = idx[::5, 0]
    val = rng.normal(size=(n, a)).astype(np.float32)
    val[:, a // 2:] *= rng.random((n, a - a // 2)) < 0.5
    val[::11] = 0.0
    return idx, val


@pytest.mark.cuda
@pytest.mark.parametrize("loss,a", [("logistic", 12), ("squared", 12),
                                    ("bandit", 7), ("logistic", 100),
                                    ("squared", 256)])
def test_k1_matches_its_plain_loop_and_repeats_bit_for_bit(cuda_device, loss,
                                                           a):
    """K1 against its plain loop (weights within 1e-5 of max |w|, per-row
    losses within 1e-5 of their largest: only the order of each
    prediction's sum differs), and two launches from one state equal bit
    for bit."""
    from mmlspark_tpu_torch.ops import online_pass as K1

    n, dim = 1500, 1 << 10
    idx, val = _k1_rows(n, a, dim, seed=a)
    rng = np.random.default_rng(1)
    y = (np.where(rng.random(n) > 0.5, 1.0, -1.0) if loss == "logistic"
         else rng.normal(size=n)).astype(np.float32)
    wt = (rng.uniform(1, 5, n).astype(np.float32) if loss == "bandit"
          else None)
    kw = dict(lr=0.5, l1=0.0 if loss == "bandit" else 1e-4,
              l2=0.0 if loss == "bandit" else 1e-3, loss=loss)
    w0 = rng.normal(size=dim).astype(np.float32) * 0.1

    def run(device, fn):
        plan = K1.plan_rows(torch.as_tensor(idx, device=device),
                            torch.as_tensor(val, device=device))
        w = torch.tensor(w0, device=device)
        g2 = torch.zeros(dim, device=device)
        out = []
        for _ in range(2):  # two passes
            out.append(fn(w, g2, plan, torch.as_tensor(y, device=device),
                          wt=None if wt is None else torch.as_tensor(
                              wt, device=device), **kw))
        return w.cpu().numpy(), g2.cpu().numpy(), \
            [(ls.cpu().numpy(), v.cpu().numpy()) for ls, v in out]

    before = K1.LAUNCHES
    w1, g1, o1 = run(cuda_device, K1.online_pass)
    torch.cuda.synchronize()
    assert K1.LAUNCHES == before + 2
    w2, g2, o2 = run(cuda_device, K1.online_pass)
    assert np.array_equal(w1, w2) and np.array_equal(g1, g2)
    for (la, va), (lb, vb) in zip(o1, o2):
        assert np.array_equal(la, lb) and np.array_equal(va, vb)
    wp, gp, op = run(torch.device("cpu"), K1.online_pass_plain)
    scale = float(np.abs(wp).max())
    np.testing.assert_allclose(w1, wp, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(g1, gp, rtol=1e-4, atol=1e-6 * gp.max())
    for (la, va), (lp, vp) in zip(o1, op):
        np.testing.assert_array_equal(va, vp)
        np.testing.assert_allclose(la, lp, atol=1e-5 * max(1.0, lp.max()))


@pytest.mark.cuda
def test_k1_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    from mmlspark_tpu_torch.ops import online_pass as K1

    w = torch.zeros(64, device=cuda_device)
    g2 = torch.zeros(64, device=cuda_device)
    y = torch.zeros(2, device=cuda_device)
    wide = K1.plan_rows(torch.zeros(2, 300, dtype=torch.int64,
                                    device=cuda_device),
                        torch.ones(2, 300, device=cuda_device))
    with pytest.raises(ValueError, match="at most"):
        K1.online_pass(w, g2, wide, y, 0.1)
    far = K1.plan_rows(torch.full((2, 3), 64, device=cuda_device),
                       torch.ones(2, 3, device=cuda_device))
    with pytest.raises(ValueError, match="outside the weight table"):
        K1.online_pass(w, g2, far, y, 0.1)
    ok = K1.plan_rows(torch.ones(2, 3, dtype=torch.int64, device=cuda_device),
                      torch.ones(2, 3, device=cuda_device))
    with pytest.raises(ValueError, match="on cpu"):
        K1.online_pass(w, g2, ok, y.cpu(), 0.1)


@pytest.mark.cuda
def test_online_learners_on_card_match_the_cpu(cuda_device):
    """The classifier and the bandit on the card (the default device)
    against their CPU fits: weights within 1e-5 of max |w|."""
    from mmlspark_tpu_torch.online import (VowpalWabbitClassifier,
                                           VowpalWabbitFeaturizer)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 6)).astype(np.float32)
    rows = np.empty(3000, object)
    for i in range(3000):
        rows[i] = x[i]
    t = VowpalWabbitFeaturizer(input_cols=["vec"], num_bits=14).transform(
        Table({"vec": rows, "label": (x[:, 0] > x[:, 1]).astype(np.int64)}))
    card = VowpalWabbitClassifier(num_passes=3).fit(t)
    cpu = VowpalWabbitClassifier(num_passes=3, device="cpu").fit(t)
    scale = float(np.abs(cpu.weights).max())
    np.testing.assert_allclose(card.weights, cpu.weights, atol=1e-5 * scale)
    np.testing.assert_allclose(card.performance_statistics["average_loss"],
                               cpu.performance_statistics["average_loss"],
                               rtol=1e-5)


@pytest.mark.cuda
def test_word2vec_on_card_matches_the_cpu_with_the_same_draws(cuda_device,
                                                               monkeypatch):
    """One set of negatives (drawn on the CPU) and one initial table for
    both fits: vectors within 1e-4 of max |v| (full-f32 products; the
    batch sums and duplicate scatters add in another order)."""
    from mmlspark_tpu_torch.featurize import Word2Vec
    from mmlspark_tpu_torch.featurize import word2vec as W

    rng = np.random.default_rng(2)
    words = [f"w{i}" for i in range(40)]
    docs = [" ".join(rng.choice(words, 10)) for _ in range(300)]
    fits = []
    for device in ("cuda", "cpu"):
        gen = torch.Generator().manual_seed(0)

        def sampler(probs, seed, dev, gen=gen):
            p = torch.as_tensor(probs)
            return lambda b, k: torch.multinomial(
                p, b * k, True, generator=gen).view(b, k).to(dev)

        monkeypatch.setattr(W, "_negative_sampler", sampler)
        fits.append(Word2Vec(vector_size=16, epochs=2, batch_size=256,
                             device=device).fit(Table({"text": docs})))
    card, cpu = fits
    assert card.vocabulary == cpu.vocabulary
    scale = float(np.abs(cpu.vectors).max())
    np.testing.assert_allclose(card.vectors, cpu.vectors, atol=1e-4 * scale)
    np.testing.assert_allclose(card.training_losses, cpu.training_losses,
                               rtol=1e-5)


@pytest.mark.cuda
def test_knn_on_card_matches_the_cpu_ties_included(cuda_device):
    """Integer keys and queries: exact products, so ties are exact on both
    devices; indices equal, distances equal."""
    from mmlspark_tpu_torch.nn import knn as K

    rng = np.random.default_rng(3)
    keys = rng.integers(-3, 4, size=(5000, 16)).astype(np.float32)
    keys[100:200] = keys[7]
    queries = rng.integers(-3, 4, size=(700, 16)).astype(np.float32)
    queries[0] = 0.0
    mask = rng.random((700, 5000)) < 0.7
    for m in (None, mask):
        vc, ic = K._batched_topk(keys, queries, 9, m)
        vp, ip = K._batched_topk(keys, queries, 9, m, device="cpu")
        np.testing.assert_array_equal(ic, ip)
        np.testing.assert_array_equal(vc, vp)


@pytest.mark.cuda
def test_sar_on_card_matches_the_cpu(cuda_device):
    from mmlspark_tpu_torch.recommendation import SAR

    rng = np.random.default_rng(4)
    n = 20000
    t = Table({"user": rng.integers(0, 600, n), "item": rng.integers(0, 300, n),
               "rating": rng.integers(1, 6, n).astype(np.float32),
               "ts": rng.uniform(0, 1e7, n)})
    for fn in ("cooccurrence", "jaccard", "lift"):
        kw = dict(similarity_function=fn, support_threshold=4,
                  timestamp_col="ts")
        card, cpu = SAR(**kw).fit(t), SAR(**kw, device="cpu").fit(t)
        if fn == "cooccurrence":
            np.testing.assert_array_equal(card.item_similarity,
                                          cpu.item_similarity)
        else:
            np.testing.assert_allclose(card.item_similarity,
                                       cpu.item_similarity, atol=1e-6)
        rc, rp = card.recommend_for_all_users(10), \
            cpu.recommend_for_all_users(10)
        same = sum(np.array_equal(a, b) for a, b in
                   zip(rc["recommendations"], rp["recommendations"]))
        # scores are products summed in another order: a rank may move
        # only where two scores lie within 1e-5 relative of each other
        for a, b, s in zip(rc["recommendations"], rp["recommendations"],
                           rp["scores"]):
            if not np.array_equal(a, b):
                s = np.sort(np.asarray(s))
                assert np.min(np.diff(s)) <= 1e-5 * max(1.0, s.max())
        assert same >= 0.99 * len(rc)


@pytest.mark.cuda
def test_isolation_forest_on_card_matches_the_cpu(cuda_device):
    from mmlspark_tpu_torch.isolationforest import IsolationForest

    x = np.random.default_rng(5).normal(size=(20000, 8)).astype(np.float32)
    card = IsolationForest(num_estimators=50, contamination=0.01).fit(
        Table({"features": x}))
    cpu = IsolationForest(num_estimators=50, contamination=0.01,
                          device="cpu").fit(Table({"features": x}))
    for a, b in zip(card.trees, cpu.trees):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(card._scores(x), cpu._scores(x), atol=1e-6)


@pytest.mark.cuda
def test_sequence_tagger_on_card_matches_the_cpu_fit(cuda_device):
    """One initial state for both fits (3 epochs of Adam, cuDNN's LSTM in
    full f32 under this file's TF32 setting): every param within 1e-3 of
    its tensor's largest magnitude."""
    from mmlspark_tpu_torch.models.bilstm import SequenceTagger

    rng = np.random.default_rng(6)
    words = [f"w{i}" for i in range(200)]
    toks, tags = np.empty(500, object), np.empty(500, object)
    for i in range(500):
        t = [str(w) for w in rng.choice(words, int(rng.integers(1, 40)))]
        toks[i], tags[i] = t, [str(int(w[1:]) % 5) for w in t]
    tab = Table({"tokens": toks, "tags": tags})
    card = SequenceTagger(epochs=3, learning_rate=1e-2).fit(tab)
    cpu = SequenceTagger(epochs=3, learning_rate=1e-2, device="cpu").fit(tab)
    for cell in card.model_params:
        for name, leaves in card.model_params[cell].items():
            ref = cpu.model_params[cell][name]
            if isinstance(leaves, dict):
                for k in leaves:
                    s = max(float(np.abs(ref[k]).max()), 1e-6)
                    np.testing.assert_allclose(leaves[k], ref[k],
                                               atol=1e-3 * s)
            else:
                s = max(float(np.abs(ref).max()), 1e-6)
                np.testing.assert_allclose(leaves, ref, atol=1e-3 * s)


@pytest.mark.cuda
def test_a_convnet_featurizer_on_card_matches_the_cpu(cuda_device):
    """convnet_cifar in f32 through B1 on the card against the CPU run: the
    featurizer test's f32 limit (1e-3 of the largest feature)."""
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.ops import image_kernels

    bundle = TorchBundle("convnet_cifar", {"num_classes": 10},
                         input_shape=(32, 32, 3), dtype="float32", seed=3)
    imgs = np.random.default_rng(7).integers(0, 256, (20, 40, 48, 3),
                                             dtype=np.uint8)
    col = np.empty(20, object)
    for i in range(20):
        col[i] = imgs[i]
    before = image_kernels.LAUNCHES
    card = np.asarray(ImageFeaturizer(bundle=bundle, batch_size=8).transform(
        Table({"image": col}))["features"])
    assert image_kernels.LAUNCHES - before == 3
    cpu = np.asarray(ImageFeaturizer(bundle=bundle, batch_size=8,
                                     device="cpu").transform(
        Table({"image": col}))["features"])
    np.testing.assert_allclose(card, cpu, atol=1e-3 * np.abs(cpu).max())


def _wls_problem(n, s, d, t, seed):
    rng = np.random.default_rng(seed)
    X = (rng.random((n, s, d)) < 0.7).astype(np.float32)
    Y = (X[:, :, :t] * 2.0 - X[:, :, -t:] +
         0.3 * rng.normal(size=(n, s, t))).astype(np.float32)
    W = np.exp(-rng.random((n, s))).astype(np.float32)
    return X, Y, W


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["wls", "lasso"])
def test_explainer_solvers_on_card_match_the_host(cuda_device, solver):
    """At ImageLIME's shape (196 superpixels, 512 samples).  The WLS is
    held against the f64 numpy solve of the same problem: on the card's
    machine a batched f32 `torch.linalg.solve` of this size on the CPU
    stopped in oneMKL (SLASWP, parameter 6) and never returned.  The lasso
    (products only) against its CPU run."""
    from mmlspark_tpu_torch.explainers import regression as R

    X, Y, W = _wls_problem(8, 512, 196, 1, seed=3)
    if solver == "wls":
        card = [a.cpu().numpy() for a in R.batch_weighted_least_squares(
            X, Y, W)]
        host = R.np_batch_weighted_least_squares(X, Y, W, l2=1e-6)
    else:
        card = [a.cpu().numpy() for a in R.batch_lasso(X, Y, W, 1e-3)]
        host = [a.numpy() for a in R.batch_lasso(X, Y, W, 1e-3,
                                                 device="cpu")]
    np.testing.assert_allclose(card[0], host[0], rtol=0,
                               atol=1e-4 * np.abs(host[0]).max())
    np.testing.assert_allclose(card[1], host[1], rtol=0,
                               atol=1e-4 * np.abs(Y).max())


@pytest.mark.cuda
def test_tabular_lime_on_card_matches_the_cpu(cuda_device):
    from mmlspark_tpu_torch import LambdaTransformer
    from mmlspark_tpu_torch.explainers import TabularLIME

    rng = np.random.default_rng(4)
    w = rng.normal(size=6).astype(np.float32)

    def score(t):
        return t.with_column("scores", np.asarray(t["features"]) @ w)

    tab = Table({"features": rng.normal(size=(16, 6)).astype(np.float32)})
    kw = dict(model=LambdaTransformer(score), num_samples=256, seed=1)
    card = np.stack(list(TabularLIME(**kw).transform(tab)["explanation"]))
    cpu = np.stack(list(TabularLIME(**kw, device="cpu").transform(
        tab)["explanation"]))
    np.testing.assert_allclose(card, cpu, rtol=0,
                               atol=1e-4 * np.abs(cpu).max())


def _access_log(n_users, n_res, n_pairs, seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, n_users * n_res, n_pairs))
    return Table({"user": (keys // n_res).astype(np.int64),
                  "res": (keys % n_res).astype(np.int64),
                  "likelihood": rng.integers(1, 60, len(keys)).astype(
                      np.float64)})


@pytest.mark.cuda
@pytest.mark.parametrize("c0", [1.0, 0.5])
def test_als_sweep_on_card_matches_the_cpu(cuda_device, c0):
    from mmlspark_tpu_torch.cyber.access_anomaly import _als_step_sparse

    rng = np.random.default_rng(int(c0 * 10))
    n_rows, n_cols, rank = 2000, 800, 8
    keys = np.unique(rng.integers(0, n_rows * n_cols, 40000))
    rows = torch.as_tensor((keys // n_cols).astype(np.int64))
    cols = torch.as_tensor((keys % n_cols).astype(np.int64))
    vals = torch.as_tensor(np.log1p(rng.integers(1, 50, len(keys))).astype(
        np.float32))
    Y = torch.as_tensor((rng.normal(size=(n_cols, rank)) * 0.3).astype(
        np.float32))
    cpu = _als_step_sparse(Y, rows, cols, vals, c0, 0.1, rank, n_rows)
    card = _als_step_sparse(Y.cuda(), rows.cuda(), cols.cuda(), vals.cuda(),
                            c0, 0.1, rank, n_rows).cpu()
    np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=0,
                               atol=1e-5 * float(cpu.abs().max()))


@pytest.mark.cuda
def test_access_anomaly_card_fits_agree(cuda_device):
    from mmlspark_tpu_torch.cyber import AccessAnomaly

    tab = _access_log(3000, 1200, 60000, seed=5)
    kw = dict(likelihood_col="likelihood", complement_ratio=0.8)
    a, b = (AccessAnomaly(**kw).fit(tab) for _ in range(2))
    sa, sb = (m.transform(tab)["anomaly_score"] for m in (a, b))
    print("two card fits bit for bit:", np.array_equal(sa, sb),
          "max |diff|", float(np.abs(sa - sb).max()))
    np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-6 * np.abs(sa).max())
    cpu = AccessAnomaly(**kw, device="cpu").fit(tab).transform(tab)
    np.testing.assert_allclose(sa, cpu["anomaly_score"], rtol=0, atol=1e-4)


# ---- device telemetry and the model side of distributed --------------------
# The ring's per-block step (B4 and the logsumexp merge) against the same
# step through B4's plain version on the same card tensors (bf16 2e-2,
# f32 1e-4 abs, B4's own limits); the 3D step at world 1 (nccl over a
# loopback store) against the single-device step, f32, 2 steps: loss
# within 1e-4 and parameters atol 1e-4 (test_torch_trainer3d.py's
# limits); the memory gauges equal torch.cuda.memory_stats.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("bfloat16", 2e-2), ("float32", 1e-4)])
def test_ring_block_step_matches_its_plain_version(cuda_device, dtype, atol):
    from mmlspark_tpu_torch.ops import attention_kernels as A
    from mmlspark_tpu_torch.parallel import ring_attention as RA

    gen = torch.Generator(device="cuda").manual_seed(7)
    shape, blk = (2, 512, 4, 64), 128
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(
        getattr(torch, dtype)) for _ in range(3))
    qr = q[:, blk:2 * blk]  # query block 1

    def merge_plain(carry, kb, vb, causal):
        o_b, lse = A.flash_attention_fwd_plain(qr, kb, vb, causal)
        return RA._merge_normalized(*carry, o_b, lse.reshape(2, 4, blk))

    # a carry that already holds block 0, then blocks 0 (behind: full),
    # 1 (diagonal: causal) and 2 (ahead: skipped, no launch)
    start = merge_plain(RA._init_carry(qr), k[:, :blk], v[:, :blk], False)
    for k_off, relation in ((0, "behind"), (blk, "diagonal"),
                            (2 * blk, "ahead")):
        kb, vb = k[:, k_off:k_off + blk], v[:, k_off:k_off + blk]
        n0 = A.LAUNCHES
        got = RA.ring_block_step(qr, kb, vb, *start, blk, k_off, True)
        assert A.LAUNCHES - n0 == (0 if relation == "ahead" else 1)
        want = start if relation == "ahead" else \
            merge_plain(start, kb, vb, relation == "diagonal")
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=atol, rtol=0)


@pytest.mark.cuda
def test_3d_step_at_world_1_matches_the_single_device_step(cuda_device):
    import torch.distributed as dist

    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models.bundle import get_builder
    from mmlspark_tpu_torch.parallel import distributed as D
    from mmlspark_tpu_torch.parallel.mesh import MeshPlan
    from mmlspark_tpu_torch.parallel.sharding_rules import lm_3d_rules
    from mmlspark_tpu_torch.utils.cluster import find_open_port

    started = not dist.is_initialized()
    if started:
        D.reset_distributed_state()
        D.initialize_distributed(f"127.0.0.1:{find_open_port(29600)}", 1, 0)
    try:
        cfg = dict(vocab_size=512, embed_dim=128, num_layers=2, num_heads=2,
                   max_len=128)
        ref = T.init_train_state(get_builder("transformer_lm")(**cfg),
                                 T.sgd(0.1), seed=3)
        plan = MeshPlan(1, 1, 1)
        p3 = T.shard_params(T.lm_params_to_3d(T.lm_params_tree(ref.module),
                                              2, 1), plan, lm_3d_rules())
        state = T.init_lm_state_3d(p3, T.sgd(0.1), plan)
        step = T.make_lm_train_step_3d(ref.module, plan, remat=True)
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, 512, (8, 128))).cuda()
        epoch = T.make_lm_train_epoch()
        for _ in range(2):
            state, m = step(state, toks.reshape(2, 2, 2, 128))
            ref, loss = epoch(ref, toks[None])
            assert abs(float(m["loss"]) - float(loss[0])) < 1e-4
        got = T.lm_params_from_3d(T.gather_params(state), 2)
        want = T.lm_params_tree(ref.module)
        from mmlspark_tpu_torch.parallel.sharding_rules import \
            tree_leaves_with_path
        for (p, a), (_q, b) in zip(tree_leaves_with_path(got),
                                   tree_leaves_with_path(want)):
            torch.testing.assert_close(a.cpu(), b.cpu(), atol=1e-4, rtol=0,
                                       msg=lambda m, p=p: f"{p}: {m}")
    finally:
        if started:
            dist.destroy_process_group()
            D.reset_distributed_state()


@pytest.mark.cuda
def test_sample_device_memory_matches_memory_stats(cuda_device):
    from mmlspark_tpu_torch.core.telemetry import device as device_obs

    keep = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    got = device_obs.sample_device_memory()
    stats = [torch.cuda.memory_stats(i)
             for i in range(torch.cuda.device_count())]
    assert got == {
        "hbm_bytes_in_use": sum(s["allocated_bytes.all.current"]
                                for s in stats),
        "hbm_peak_bytes": sum(s["allocated_bytes.all.peak"] for s in stats),
        "live_buffer_count": sum(s["allocation.all.current"] for s in stats)}
    assert got["hbm_bytes_in_use"] >= keep.numel() * 4
    del keep


# ---- the data side of distributed (PR 19 slice): the card's ring and
# buckets, which a CPU device never uses (torch.from_numpy aliases)

@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 4])
def test_coalescing_run_reuses_its_pinned_ring_on_the_card(cuda_device,
                                                           depth):
    """24 same-shape chunks at coalesce 2: 12 packed copies through a ring
    of depth + 1 pinned slots, each rewritten only behind its fence, and
    every chunk's output equal to its host computation."""
    rng = np.random.default_rng(0)
    chunks = [(rng.integers(0, 250, (4, 16, 3)).astype(np.uint8), 4)
              for _ in range(24)]
    feed = DeviceFeed(cuda_device, depth=depth, coalesce=2,
                      telemetry=FeedTelemetry())
    got = feed.run(iter(chunks), lambda x: x.to(torch.int32) + 1,
                   greedy=False)
    for g, (c, _n) in zip(got, chunks):
        np.testing.assert_array_equal(g, c.astype(np.int32) + 1)
    rings = list(feed._rings.values())
    assert len(rings) == 1 and len(rings[0]) == depth + 1
    snap = feed.telemetry.snapshot()
    assert snap["groups"] == 12 and snap["coalesced_chunks"] == 24


@pytest.mark.cuda
def test_shard_engine_reuses_one_fenced_pinned_bucket(cuda_device):
    """A world-1 nccl mesh: put_sharded keeps the copied block (no second
    copy) and reuses one pinned bucket behind its fence."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.io import shard_put as SP
    from mmlspark_tpu_torch.parallel import distributed as D
    from mmlspark_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from mmlspark_tpu_torch.utils.cluster import find_open_port

    started = not dist.is_initialized()
    if started:
        D.reset_distributed_state()
        D.initialize_distributed(f"127.0.0.1:{find_open_port(29650)}", 1, 0)
    try:
        mesh = make_mesh()
        staging = SP.StagingBuckets()
        eng = SP.ShardEngine(telemetry=FeedTelemetry(), staging=staging,
                             min_shard_bytes=0)
        rng = np.random.default_rng(1)
        srcs = [rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
                for _ in range(2)]
        outs = [eng.put_sharded(srcs[i % 2], batch_sharding(mesh, 4))
                for i in range(6)]
        torch.cuda.synchronize()
        for i, y in enumerate(outs):
            assert y.to_local().is_cuda
            np.testing.assert_array_equal(y.to_local().cpu().numpy(),
                                          srcs[i % 2])
        assert staging.allocated() == 1
        again = staging.acquire(srcs[0].nbytes, pinned=True)
        assert again.host.is_pinned() and staging.allocated() == 1
    finally:
        if started:
            dist.destroy_process_group()
            D.reset_distributed_state()


# ---- device timing of the feed's copies and of DeepVisionClassifier's
# steps: timing events, which a CPU device never records

@pytest.mark.cuda
def test_the_feed_times_its_copies_on_the_card(cuda_device):
    """Every copy of a stream is timed on the card once its fence has
    completed (the rest read by `query()` after a synchronise)."""
    rng = np.random.default_rng(2)
    items = [(rng.integers(0, 250, (4, 64, 64, 3)).astype(np.uint8),
              rng.integers(0, 9, (4,)).astype(np.int32)) for _ in range(7)]
    tel = FeedTelemetry()
    feed = DeviceFeed(cuda_device, depth=2, telemetry=tel)
    outs = list(feed.stream(iter(items)))
    torch.cuda.synchronize()
    feed._read_finished_copies()
    for (hx, hy), (dx, dy) in zip(items, outs):
        np.testing.assert_array_equal(dx.cpu().numpy(), hx)
        np.testing.assert_array_equal(dy.cpu().numpy(), hy)
    snap = tel.snapshot()
    assert snap["transfer_calls"] == 7
    assert snap["h2d_device_bytes"] == snap["bytes_moved"]
    assert snap["h2d_device_s"] > 0
    (ring,) = feed._rings.values()
    assert len(ring) == 3 and all(slot.start is None for slot in ring)
    assert FeedTelemetry.summarize(snap)["h2d_gbps"] > 0


@pytest.mark.cuda
def test_a_fit_on_the_card_times_each_step_on_the_device(cuda_device):
    """One `training.step.device` span a step, under its epoch, in step
    order, not overlapping, inside the epoch's host span, and each
    observed in `models.training.step_device_latency`."""
    from mmlspark_tpu_torch.core import telemetry
    from mmlspark_tpu_torch.models.deep_vision import DeepVisionClassifier

    rng = np.random.default_rng(3)
    col = np.empty(48, object)
    for i in range(48):
        col[i] = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    hist = telemetry.histogram("models.training.step_device_latency")
    before = hist.snapshot()["count"]
    DeepVisionClassifier(backbone="resnet18", epochs=2, batch_size=8,
                         device="cuda").fit(
        Table({"image": col, "label": np.asarray(["a", "b"] * 24)}))
    root = [s for s in telemetry.recent_spans()
            if s["name"] == "deep_vision.fit"][-1]
    spans = telemetry.get_trace(root["trace_id"])
    assert root["attrs"]["steps"] == 12
    init = next(s for s in spans if s["name"] == "deep_vision.init")
    assert init["attrs"] == {"init_path": "direct"}
    epochs = {s["span_id"]: s for s in spans
              if s["name"] == "deep_vision.epoch"}
    device = [s for s in spans if s["name"] == "training.step.device"]
    assert len(device) == 12
    assert hist.snapshot()["count"] - before == 12
    for epoch_id, epoch in epochs.items():
        mine = [s for s in device if s["parent_id"] == epoch_id]
        assert len(mine) == 6
        assert sum(s["wall_s"] for s in mine) <= epoch["wall_s"]
        for a, b in zip(mine, mine[1:]):
            assert a["wall_s"] > 0
            assert a["t_start"] + a["wall_s"] <= b["t_start"] + 1e-6
        assert mine[0]["t_start"] >= epoch["t_start"] - 1e-3
        assert mine[-1]["t_start"] + mine[-1]["wall_s"] <= \
            epoch["t_start"] + epoch["wall_s"] + 1e-3


@pytest.mark.cuda
def test_direct_init_lands_a_pinned_draw_on_the_card(cuda_device):
    """The fit's direct path on the card: the module placed on the card
    uninitialised, each draw staged in pinned host memory, one copy to the
    card, and the leaves equal bit for bit to `init_state_dict`'s on the
    host; two draws landed back to back, without a synchronise between
    them, each keep their own seed's bits."""
    from mmlspark_tpu_torch.models.bundle import DirectInit

    kwargs = {"num_classes": 10}
    landed = {}
    for seed in (11, 12):
        direct = DirectInit.build("resnet18", kwargs, cuda_device)
        assert direct is not None
        assert all(t.is_cuda for t in direct.module.state_dict().values())
        flat = direct.draw(seed, pin_memory=True)
        assert flat.is_pinned() and flat.numel() == direct.numel
        direct.land(flat)
        del flat
        landed[seed] = direct.module
    torch.cuda.synchronize()
    for seed, module in landed.items():
        want = init_state_dict(get_builder("resnet18")(**kwargs), seed)
        got = module.state_dict()
        assert list(got) == list(want)
        for k, v in want.items():
            assert torch.equal(got[k].cpu(), torch.from_numpy(v)), (seed, k)
