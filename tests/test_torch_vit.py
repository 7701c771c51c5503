"""The port's Vision Transformer (mmlspark_tpu_torch.models.vit) and its
ImageFeaturizer path held against the JAX package's on the same weights
(every flax leaf random, bridged with `from_flax_variables`) and the same
numpy inputs: a one-layer ViT at patch 16, embed 128, 2 heads, 224x224
(so S = 196, the ViT-B/16 sequence length), in f32.

The JAX side takes its single-chip attention branch, the Pallas flash
kernel in interpret mode (S padded 196 -> 256 under key masking), by
forcing the dispatch predicate, as test_vit.py:125-144 does; the port on
the CPU runs the kernel's plain version.

Tolerance: 2e-4 abs and rel on every tap, the JAX suite's own for the
ViT's kernel-vs-dense logits (test_vit.py:144); features through the
featurizer within 2e-4 of their largest magnitude (the resize weights
and the patch conv are summed in another order; observed ~1e-6).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.models import transformer as T
from mmlspark_tpu.models.bundle import FlaxBundle
from mmlspark_tpu.models.bundle import register_builder as j_register
from mmlspark_tpu.models.image_featurizer import ImageFeaturizer as JFeaturizer
from mmlspark_tpu.models.vit import VisionTransformer as JViT
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.models import vit as PV
from mmlspark_tpu_torch.models.bundle import (TorchBundle, from_flax_variables,
                                              register_builder)
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models.zoo import ModelRepo, get_or_create_resnet

from torch_port_util import random_transformer_params, to_dicts

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
HW, CLASSES = 224, 5
BUILDER = "vit_test_one_layer"
LAYER = dict(patch_size=16, embed_dim=128, num_layers=1, num_heads=2)

j_register(BUILDER, lambda num_classes=CLASSES, dtype=jnp.float32:
           JViT(num_classes=num_classes, dtype=dtype, **LAYER))
register_builder(BUILDER, lambda num_classes=CLASSES, image_size=HW,
                 attn_fn=None: PV.VisionTransformer(
                     num_classes=num_classes, image_size=image_size,
                     attn_fn=attn_fn, **LAYER))


@pytest.fixture(scope="module")
def weights():
    x = np.random.default_rng(3).standard_normal((2, HW, HW, 3)).astype(
        np.float32)
    variables = random_transformer_params(JViT(num_classes=CLASSES,
                                               dtype=jnp.float32, **LAYER),
                                          jnp.asarray(x[:1]), seed=8)
    bundle = from_flax_variables(BUILDER, variables, {"num_classes": CLASSES},
                                 input_shape=(HW, HW, 3), dtype="float32")
    return variables, bundle, x


@pytest.fixture
def kernel_path(monkeypatch):
    monkeypatch.setattr(T, "_single_tpu", lambda: True)


def test_every_tap_matches_jax(weights, kernel_path):
    variables, bundle, x = weights
    model = JViT(num_classes=CLASSES, dtype=jnp.float32, **LAYER)
    _logits, ref = model.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = bundle.apply(bundle.module(torch.device("cpu")),
                           torch.from_numpy(x))
    assert bundle.layer_names == JViT.layer_names
    assert bundle.builder_kwargs["image_size"] == (HW, HW)
    assert sorted(got) == sorted(ref) == sorted(bundle.layer_names)
    assert got["embed"].shape == (2, 196, 128)
    for k in bundle.layer_names:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


def test_trouble_spot_patch_order(weights):
    """The conv's NCHW output is permuted to flax's NHWC before it is
    flattened; flattening NCHW directly would scramble the patches."""
    variables, bundle, x = weights
    model = JViT(num_classes=CLASSES, dtype=jnp.float32, **LAYER)
    _logits, ref = model.apply(variables, jnp.asarray(x))
    module = bundle.module(torch.device("cpu"))
    with torch.inference_mode():
        conv = module.patch_embed(torch.from_numpy(x).permute(0, 3, 1, 2))
        scrambled = (conv.reshape(2, 196, 128) + module.pos_embed).numpy()
        embed = module(torch.from_numpy(x))[1]["embed"].numpy()
    np.testing.assert_allclose(embed, np.asarray(ref["embed"]), **TOL)
    assert np.abs(scrambled - np.asarray(ref["embed"])).max() > 1e-2


def _images():
    rng = np.random.default_rng(5)
    sizes = [(240, 240, 3), (224, 224, 3), (200, 256, 3)]
    return [rng.integers(0, 256, size=sizes[k], dtype=np.uint8)
            for k in (0, 1, 2, 0, 1)]


@pytest.mark.parametrize("cut", [1, 0])
def test_featurizer_matches_jax(weights, kernel_path, cut):
    variables, bundle, _x = weights
    jb = FlaxBundle(BUILDER, {"num_classes": CLASSES}, variables=variables,
                    input_shape=(HW, HW, 3))
    images = _images()
    ref = JFeaturizer(bundle=jb, batch_size=2, cut_output_layers=cut
                      ).transform(JTable({"image": images}))["features"]
    got = ImageFeaturizer(bundle=bundle, batch_size=2, cut_output_layers=cut,
                          device="cpu").transform(
        Table({"image": images}))["features"]
    assert got.shape == ref.shape == (5, 128 if cut == 1 else CLASSES)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 * scale)


def test_patch_divisibility_rejected():
    with pytest.raises(ValueError, match="divisible by patch_size"):
        PV.vit_tiny(num_classes=3, image_size=30)
    m = PV.VisionTransformer(num_layers=1, image_size=32)
    with pytest.raises(ValueError, match="divisible by patch_size"):
        m(torch.zeros(1, 30, 30, 3))
    with pytest.raises(ValueError, match="built for 32x32"):
        m(torch.zeros(1, 48, 48, 3))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """Both entry points of the slice run on the card unless the caller
    passes device='cpu'; without a card they raise."""
    from mmlspark_tpu_torch.models.generation import generate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vit = TorchBundle("vit_tiny", {"num_classes": 3}, input_shape=(32, 32, 3))
    table = Table({"image": [np.zeros((40, 40, 3), np.uint8)]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImageFeaturizer(bundle=vit).transform(table)
    assert ImageFeaturizer(bundle=vit, device="cpu").transform(
        table)["features"].shape == (1, 192)
    lm = TorchBundle("transformer_lm", {"vocab_size": 16, "embed_dim": 16,
                                        "num_layers": 1, "num_heads": 2,
                                        "max_len": 8}, input_shape=(4,))
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(lm, prompt, 2)
    assert generate(lm, prompt, 2, device="cpu").shape == (1, 6)


def test_zoo_creates_any_registered_builder(tmp_path):
    """get_or_create_resnet seeds any registered builder, and the bundle
    takes its taps from the module, not ResNet's."""
    repo = ModelRepo(str(tmp_path))
    a = get_or_create_resnet("vit_tiny", (32, 32, 3), 7, repo=repo)
    b = get_or_create_resnet("vit_tiny", (32, 32, 3), 7, repo=repo)
    assert b.bundle_id == a.bundle_id
    assert a.layer_names == ["logits", "pool", "encoded", "embed"]
    assert repo.get_schema("vit_tiny_32x32_7").layer_names == a.layer_names
    assert a.state_dict["pos_embed"].shape == (1, 4, 192)
    assert a.state_dict["blocks.0.ln1.weight"].min() == 1.0
    lm = TorchBundle("transformer_lm", {"vocab_size": 16, "embed_dim": 16,
                                        "num_layers": 1, "num_heads": 2,
                                        "max_len": 8}, input_shape=(8,))
    assert lm.layer_names == ["logits", "pool", "hidden", "embed"]
    assert lm.input_dtype == "int32"


def test_bridge_raises_on_leftover_and_missing_leaves(weights):
    variables, _bundle, _x = weights
    params = to_dicts(variables["params"])
    kw = {"num_classes": CLASSES}
    extra = {"params": dict(params, stray=np.zeros(3, np.float32))}
    with pytest.raises(KeyError):
        from_flax_variables(BUILDER, extra, kw, input_shape=(HW, HW, 3))
    missing = {"params": {k: v for k, v in params.items()
                          if k != "pos_embed"}}
    with pytest.raises(KeyError):
        from_flax_variables(BUILDER, missing, kw, input_shape=(HW, HW, 3))
    with pytest.raises(ValueError):
        from_flax_variables(BUILDER, variables, kw, input_shape=(160, 160, 3))


# ViT-tiny's width (embed 192, 3 heads -> D 64) with 2 layers at 64x64:
# S = 16, which the JAX package's kernels take natively
TINY = "vit_test_tiny_two_layers"
TINY_LAYERS = dict(patch_size=16, embed_dim=192, num_layers=2, num_heads=3)
TINY_HW = 64

j_register(TINY, lambda num_classes=CLASSES, dtype=jnp.float32:
           JViT(num_classes=num_classes, dtype=dtype, **TINY_LAYERS))
register_builder(TINY, lambda num_classes=CLASSES, image_size=TINY_HW,
                 attn_fn=None: PV.VisionTransformer(
                     num_classes=num_classes, image_size=image_size,
                     attn_fn=attn_fn, **TINY_LAYERS))


def test_vit_tiny_backward_matches_jax(kernel_path):
    """Gradients of every parameter of a ViT-tiny-width model (mean squared
    logits) through the port's autograd — fused_attention's flash
    backward, plain on the CPU — against `jax.grad` with the JAX model on
    its Pallas forward and backward kernels (interpret mode).  Within 1e-4
    of each gradient's scale, the JAX suite's off-TPU GRAD_TOL
    (test_attention_kernels.py:27): f32 on both sides."""
    x = np.random.default_rng(12).standard_normal(
        (2, TINY_HW, TINY_HW, 3)).astype(np.float32)
    model = JViT(num_classes=CLASSES, dtype=jnp.float32, **TINY_LAYERS)
    variables = random_transformer_params(model, jnp.asarray(x[:1]), seed=13)

    def loss(params):
        logits, _ = model.apply({"params": params}, jnp.asarray(x))
        return jnp.mean(logits ** 2)

    kw = {"num_classes": CLASSES}
    ref = from_flax_variables(
        TINY, {"params": to_dicts(jax.grad(loss)(variables["params"]))}, kw,
        input_shape=(TINY_HW, TINY_HW, 3), dtype="float32").state_dict
    module = from_flax_variables(TINY, variables, kw,
                                 input_shape=(TINY_HW, TINY_HW, 3),
                                 dtype="float32").module(torch.device("cpu"))
    logits, _ = module(torch.from_numpy(x))
    (logits ** 2).mean().backward()
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(p.grad.numpy(), ref[name], err_msg=name,
                                   atol=1e-4 * scale, rtol=0)
