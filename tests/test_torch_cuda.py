"""Tests of mmlspark_tpu_torch that need a CUDA card: each kernel against
its plain PyTorch version on the card, and the card paths that run them
(the featurizer over a ResNet and a ViT, `generate` over a TransformerLM,
the ContinuousBatcher's paged decode, and the flash backward under a
TransformerLM's `loss.backward()`).
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
"""
import functools

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
