"""The port's Switch mixture-of-experts blocks (mmlspark_tpu_torch.models.
transformer `_MoEMLP`, `moe_experts` in TransformerLM and the ViT) and
their load-balance loss in the trainers, held against the JAX package's
on bridged weights (every flax leaf random) and the same numpy inputs.

Tolerances: logits and features 2e-4 abs and rel in f32 (the port's
`TOL`, tests/test_torch_transformer.py); the aux losses the same.  Train
steps as tests/test_torch_training.py holds the dense LM: losses rtol
1e-4 / atol 1e-5, parameters after Adam 5e-5 abs.  Greedy tokens must be
identical.  The indexing dispatch and combine are held against the JAX
package's one-hot einsum form, written here in PyTorch, EXACTLY: each
output element of those einsums has one non-zero term.

The JAX side runs its default attention on the CPU (dense
`full_attention`); the attention kernels are the business of
tests/test_torch_transformer.py.
"""
import functools

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import generation as JG
from mmlspark_tpu.models import training as JT
from mmlspark_tpu.models import transformer as T
from mmlspark_tpu.models.vit import VisionTransformer as JViT
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu_torch.models import generation as G
from mmlspark_tpu_torch.models import training as PT
from mmlspark_tpu_torch.models import transformer as PTR
from mmlspark_tpu_torch.models import vit as PV
from mmlspark_tpu_torch.models.bundle import (TorchBundle, from_flax_variables,
                                              register_builder)

from torch_port_util import random_transformer_params, to_dicts

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)   # test_torch_training.py's
ADAM_ATOL = 5e-5                        # test_torch_training.py's
V, E, H, S, MAX_LEN, X = 64, 64, 2, 24, 40, 4
# 1.25: cap = int(1.25 * 24 / 4) = 7 slots an expert a row, which the
# random routing overflows; 4.0 (>= X experts) never drops
CAPACITIES = {"dropping": 1.25, "drop_free": 4.0}

VIT_BUILDER = "vit_test_moe"
VIT = dict(patch_size=8, embed_dim=64, num_layers=2, num_heads=2,
           moe_experts=X)
HW, CLASSES = 32, 5
register_builder(VIT_BUILDER, lambda num_classes=CLASSES, image_size=HW,
                 attn_fn=None: PV.VisionTransformer(
                     num_classes=num_classes, image_size=image_size,
                     attn_fn=attn_fn, **VIT))


def _mesh1():
    return make_mesh(data=1, devices=jax.devices()[:1])


def _kw(capacity, layers=2):
    return dict(vocab_size=V, embed_dim=E, num_heads=H, num_layers=layers,
                max_len=MAX_LEN, moe_experts=X, moe_capacity=capacity)


@functools.lru_cache(maxsize=None)
def _lm(capacity, layers=2, seed=2):
    kw = _kw(capacity, layers)
    model = T.transformer_lm(dtype=jnp.float32, **kw)
    variables = random_transformer_params(model, jnp.zeros((1, 4), jnp.int32),
                                          seed=seed)
    bundle = from_flax_variables("transformer_lm", variables, kw,
                                 dtype="float32")
    return model, variables, bundle


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_forward(capacity):
    model, variables, _bundle = _lm(capacity)
    (logits, _taps), mut = model.apply(variables, jnp.asarray(_tokens((3, S))),
                                       mutable=["losses"])
    aux = [float(mut["losses"][f"block{i}"]["moe"]["moe_aux"][0])
           for i in range(2)]
    return np.asarray(logits), aux


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
def test_moe_lm_logits_and_aux_match_jax(capacity):
    ref, ref_aux = _jax_forward(CAPACITIES[capacity])
    bundle = _lm(CAPACITIES[capacity])[2]
    module = bundle.module(torch.device("cpu"))
    aux = []
    with torch.no_grad():
        logits, _taps = module(torch.from_numpy(_tokens((3, S))), aux=aux)
    np.testing.assert_allclose(logits.numpy(), ref, **TOL)
    # the aux term equals the sown moe_aux, layer by layer
    np.testing.assert_allclose([float(a) for a in aux], ref_aux, **TOL)
    # the dropping capacity really drops (and the drop-free one does not)
    moe = module.blocks[0].moe
    x = module.blocks[0].ln2(module._embed(torch.from_numpy(_tokens((3, S))),
                                           0))
    with torch.no_grad():
        _p, _e, _g, place = moe.route(x)
    assert bool((place >= moe.capacity(S)).any()) == (capacity == "dropping")


def test_forward_without_aux_list_computes_no_aux():
    """The aux terms reach a caller only through the list it hands the
    forward: two forwards, one without the list, leave only the second's
    terms, so an unasked forward cannot leak into the next loss."""
    module = _lm(CAPACITIES["dropping"])[2].module(torch.device("cpu"))
    toks = torch.from_numpy(_tokens((2, S)))
    aux = []
    with torch.no_grad():
        module(toks)
        module(toks, aux=aux)
    assert len(aux) == 2 and all(a.dim() == 0 for a in aux)


def test_moe_rows_are_independent_of_co_tenants():
    """Capacity binds per row and the queue cumsum runs along s within a
    row: a row's logits do not change with its batchmates, at a tight
    capacity (the reference's tests/test_transformer.py:196)."""
    module = _lm(0.5)[2].module(torch.device("cpu"))
    row, other = _tokens((1, 16), seed=3), _tokens((3, 16), seed=4)
    with torch.no_grad():
        solo = module(torch.from_numpy(row))[0]
        batched = module(torch.from_numpy(np.concatenate([row, other])))[0]
    np.testing.assert_allclose(batched[0].numpy(), solo[0].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_moe_decode_matches_full_forward_and_jax_generate():
    """At drop-free capacity KV-cached greedy decode equals the naive
    recompute of full forwards (tests/test_transformer.py:171) and JAX
    `generate`'s tokens."""
    model, variables, bundle = _lm(CAPACITIES["drop_free"])
    prompt = _tokens((2, 5), seed=6)
    got = G.generate(bundle, prompt, 8, device="cpu").numpy()
    module = bundle.module(torch.device("cpu"))
    toks = torch.from_numpy(prompt)
    with torch.no_grad():
        for _ in range(8):
            nxt = module(toks)[0][:, -1].argmax(-1).to(torch.int32)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(got, toks.numpy())
    ref = np.asarray(JG.generate(model, variables, jnp.asarray(prompt), 8))
    np.testing.assert_array_equal(got, ref)


def _einsum_moe(moe, x):
    """The JAX package's dispatch and combine (transformer.py:131-161):
    one-hot [B, S, X, cap] tensors and einsums around the same route
    and experts."""
    b, s, e = x.shape
    nx, cap = moe.num_experts, moe.capacity(s)
    _probs, expert, gate, place = moe.route(x)
    keep = (place < cap).to(x.dtype)
    disp = (F.one_hot(expert, nx).to(x.dtype)[..., None]
            * F.one_hot(place.clamp(max=cap - 1), cap).to(x.dtype)[:, :, None]
            * keep[..., None, None])                         # [B, S, X, C]
    buf = torch.einsum("bse,bsxc->xbce", x, disp).reshape(nx, b * cap, e)
    y = moe.experts(buf).reshape(nx, b, cap, e)
    return torch.einsum("xbce,bsxc->bse", y, disp) * gate.to(x.dtype)[..., None]


@pytest.mark.parametrize("capacity", [0.5, 1.25, 4.0])
def test_indexing_dispatch_equals_the_one_hot_einsums_exactly(capacity):
    torch.manual_seed(0)
    moe = PTR._MoEMLP(16, 4, X, capacity)
    for p in moe.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.randn(3, 12, 16)
    g = torch.randn(3, 12, 16)
    outs, grads = [], []
    for fn in (lambda xx: moe(xx, []), lambda xx: _einsum_moe(moe, xx)):
        xx = x.clone().requires_grad_(True)
        out = fn(xx)
        (out * g).sum().backward()
        outs.append(out.detach())
        grads.append([xx.grad] + [p.grad.clone() for p in moe.parameters()])
        moe.zero_grad()
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_moe_mlp_materialises_no_one_hot_dispatch(monkeypatch):
    """Dispatch and combine index; no [B, S, X, cap] tensor is built."""
    moe = PTR._MoEMLP(16, 4, X, 4.0)
    made = []
    real = torch.Tensor.__mul__

    def spy(a, b):
        out = real(a, b)
        made.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch.Tensor, "__mul__", spy)
    moe(torch.randn(2, 12, 16), [])
    assert all(len(s) < 4 for s in made), made


@functools.lru_cache(maxsize=None)
def _lm_train_case():
    kw = _kw(CAPACITIES["dropping"])
    model = T.transformer_lm(dtype=jnp.float32, **kw)
    tokens = _tokens((2, 2, S), seed=7)
    variables = random_transformer_params(model, jnp.asarray(tokens[0]),
                                          seed=8)
    opt = optax.adam(3e-4)
    epoch = JT.make_lm_train_epoch(model, opt, mesh=_mesh1(), donate=False)
    params, _opt, losses = epoch(variables["params"],
                                 opt.init(variables["params"]),
                                 jnp.asarray(tokens))
    final = from_flax_variables(
        "transformer_lm",
        {"params": to_dicts(jax.tree.map(np.asarray, params))}, kw,
        dtype="float32").state_dict
    return kw, variables, tokens, np.asarray(losses), final


def test_two_moe_lm_train_steps_match_jax():
    kw, variables, tokens, ref_losses, ref_final = _lm_train_case()
    bundle = from_flax_variables("transformer_lm", variables, kw,
                                 dtype="float32")
    state = PT.TrainState.create(bundle.module(torch.device("cpu")),
                                 PT.adam(3e-4), device="cpu")
    state, losses = PT.make_lm_train_epoch()(state, torch.from_numpy(tokens))
    np.testing.assert_allclose(losses.numpy(), ref_losses, **LOSS_TOL)
    # the aux term is in the loss: the cross-entropy alone is lower
    module = bundle.module(torch.device("cpu"))
    with torch.no_grad():
        ce = PT.lm_loss(module(torch.from_numpy(tokens[0]))[0],
                        torch.from_numpy(tokens[0]))
    assert float(losses[0]) - float(ce) > 0.005
    got = {k: v.detach().numpy() for k, v in state.module.state_dict().items()}
    assert sorted(got) == sorted(ref_final)
    for k, ref in ref_final.items():
        np.testing.assert_allclose(got[k], ref, atol=ADAM_ATOL, rtol=0,
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _vit_case():
    model = JViT(num_classes=CLASSES, dtype=jnp.float32, **VIT)
    rng = np.random.default_rng(9)
    images = rng.standard_normal((1, 4, HW, HW, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, (1, 4)).astype(np.int32)
    variables = random_transformer_params(model, jnp.asarray(images[0, :1]),
                                          seed=10)
    _logits, taps = model.apply(variables, jnp.asarray(images[0]))
    opt = optax.sgd(0.1)
    epoch = JT.make_train_epoch(model, opt, CLASSES, mesh=_mesh1(),
                                donate=False)
    state = JT.TrainState(variables["params"], {},
                          opt.init(variables["params"]))
    state, metrics = epoch(state, jnp.asarray(images), jnp.asarray(labels))
    final = from_flax_variables(
        VIT_BUILDER,
        {"params": to_dicts(jax.tree.map(np.asarray, state.params))},
        input_shape=(HW, HW, 3), dtype="float32").state_dict
    return (variables, images, labels, {k: np.asarray(v) for k, v in
                                        taps.items()},
            {k: np.asarray(v) for k, v in metrics.items()}, final)


def _vit_bundle(variables):
    return from_flax_variables(VIT_BUILDER, variables,
                               input_shape=(HW, HW, 3), dtype="float32")


def test_vit_moe_features_match_jax():
    variables, images, _labels, ref, _m, _f = _vit_case()
    bundle = _vit_bundle(variables)
    with torch.no_grad():
        got = bundle.apply(bundle.module(torch.device("cpu")),
                           torch.from_numpy(images[0]))
    for k in ("pool", "logits"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], err_msg=k, **TOL)


def test_vit_moe_train_epoch_step_matches_jax():
    """One `make_train_epoch` step of the V-MoE, SGD 0.1: the loss (with
    0.01 x the aux terms), accuracy and every parameter."""
    variables, images, labels, _taps, ref_m, ref_final = _vit_case()
    state = PT.TrainState.create(
        _vit_bundle(variables).module(torch.device("cpu")), PT.sgd(0.1),
        device="cpu")
    state, m = PT.make_train_epoch(CLASSES)(state, torch.from_numpy(images),
                                            torch.from_numpy(labels))
    np.testing.assert_allclose(m["loss"].numpy(), ref_m["loss"], **LOSS_TOL)
    np.testing.assert_allclose(m["accuracy"].numpy(), ref_m["accuracy"])
    got = state.module.state_dict()
    for k, ref in ref_final.items():
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got[k].numpy(), ref, atol=2e-5 * scale,
                                   rtol=0, err_msg=k)


def test_router_stays_f32_under_bf16():
    """In the bundle's cast, a later `.to(bfloat16)` and the trainer's
    bf16 working copy, the router keeps f32 weights while the experts
    take the compute dtype; a bf16 step runs and updates the f32 master
    router."""
    kw = _kw(CAPACITIES["drop_free"])
    bundle = TorchBundle("transformer_lm", kw, dtype="bfloat16", seed=0)
    module = bundle.module(torch.device("cpu"))
    for m in (module, module.to(torch.bfloat16)):
        router = m.blocks[1].moe.router
        assert router.weight.dtype == router.bias.dtype == torch.float32
        assert m.blocks[1].moe.w_in.dtype == torch.bfloat16
    with torch.no_grad():
        logits, _taps = module(torch.from_numpy(_tokens((1, 8))))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    state = PT.init_train_state(PTR.transformer_lm(**kw), PT.adam(1e-2),
                                seed=0, compute_dtype="bfloat16",
                                device="cpu")
    work_router = state.work.blocks[0].moe.router
    assert work_router.weight.dtype == torch.float32
    assert state.work.blocks[0].moe.w_in.dtype == torch.bfloat16
    before = state.module.blocks[0].moe.router.weight.detach().clone()
    state, losses = PT.make_lm_train_epoch()(
        state, torch.from_numpy(_tokens((1, 2, 16))))
    assert torch.isfinite(losses).all()
    after = state.module.blocks[0].moe.router.weight
    assert not torch.equal(before, after)
    assert torch.equal(work_router.weight, after)


def test_random_init_expert_kernels_follow_flax_fan_in():
    """flax's lecun_normal on a 3-D kernel counts the expert axis in the
    fan-in: w_in ~ 1/sqrt(X E), w_out ~ 1/sqrt(X mE)."""
    kw = dict(_kw(1.25), embed_dim=128, moe_experts=8)
    sd = TorchBundle("transformer_lm", kw, dtype="float32", seed=0).state_dict
    for name, fan_in in (("w_in", 8 * 128), ("w_out", 8 * 512)):
        std = float(sd[f"blocks.0.moe.{name}"].std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.02, (name, std)
    assert float(np.abs(sd["blocks.0.moe.router.bias"]).max()) == 0.0
