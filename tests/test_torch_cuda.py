"""Tests of mmlspark_tpu_torch that need a CUDA card: each kernel against
its plain PyTorch version on the card, and the card paths that run them
(the featurizer over a ResNet and a ViT, `generate` over a TransformerLM).
They skip without a card (the kernels have no CPU mode).  This file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the resize kernel atol=1e-3, rtol=1e-4 in normalized units,
as for its CPU parity test against the JAX package
(test_torch_image_kernels.py); the attention kernel 1e-4 abs for f32
inputs and 2e-2 for bf16 (it rounds the probabilities to bf16
unnormalized, the plain version normalized), its logsumexp 1e-4.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.models.bundle import (TorchBundle, get_builder,
                                              init_state_dict)
from mmlspark_tpu_torch.models.generation import generate
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.ops import attention_kernels as A
from mmlspark_tpu_torch.ops import image_kernels as K

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
