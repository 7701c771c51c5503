"""`lfm2_moe` (models/lfm2.py, models/moe.py) against the plain float32
reference (perfbench/reference/lfm2.py) on the CPU, at a tiny size of
LFM2-8B-A1B's shape: hidden 64, 4 query heads over 2 K/V heads, both
layer kinds, one dense SwiGLU layer, 8 experts top-2 of which a layer
holds 4, vocabulary 512, 24 tokens.

Tolerances: the port and the reference compute the same float32
arithmetic in different orders (fused RMSNorm, one attention product
against blocks, grouped against per-expert sums), so logits and the loss
agree to ~1e-6 relative and gradients to ~1e-5; the bounds below are 1e-4
(forward) and 1e-3 (a leaf's gradient and the parameters' change after
three Adam steps, where Adam's division by sqrt(v) can double a relative
difference).  The routing, causality and expert-share checks hold
exactly or to 1e-5."""
import copy

import pytest
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core import telemetry
from mmlspark_tpu_torch.models import bundle, lfm2, moe, training
from mmlspark_tpu_torch.models.bundle import DirectInit, init_state_dict
from perfbench.reference import lfm2 as ref

torch.set_num_threads(2)

TINY = {"vocab_size": 512, "hidden_size": 64,
        "layer_types": ["conv", "full_attention", "conv", "full_attention"],
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 96, "moe_intermediate_size": 32,
        "num_dense_layers": 1, "num_experts": 4, "num_experts_per_tok": 2,
        "norm_eps": 1e-5, "rope_theta": 1e6, "conv_L_cache": 3,
        "expert_offset": 2, "published": {"num_experts": 8}}
SEQ = 24
SEEDS = (0, 2 ** 31 + 7)


def _cfg(**over):
    cfg = copy.deepcopy(TINY)
    cfg.update(over)
    return cfg


def _kwargs(cfg):
    kw = {k: cfg[k] for k in (
        "vocab_size", "hidden_size", "layer_types", "num_attention_heads",
        "num_key_value_heads", "intermediate_size", "moe_intermediate_size",
        "num_dense_layers", "num_experts_per_tok", "norm_eps", "rope_theta",
        "conv_L_cache", "expert_offset")}
    kw["num_experts"] = cfg["published"]["num_experts"]
    kw["experts_held"] = cfg["num_experts"]
    return kw


def _model(cfg, seed):
    direct = DirectInit.build("lfm2_moe", _kwargs(cfg), "cpu")
    direct.land(direct.draw(seed))
    return direct.module


def _tokens(n, seed=5, seq=SEQ):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab_size"], (n, seq), generator=g)


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("seed", SEEDS)
def test_direct_init_is_init_state_dict_and_the_references_draw(seed):
    cfg = _cfg()
    direct = DirectInit.build("lfm2_moe", _kwargs(cfg), "cpu")
    assert direct is not None
    # the tied head is drawn once: the plan has one entry a distinct tensor
    assert direct.numel == sum(p.numel() for p in direct.module.parameters()) \
        + sum(b.numel() for b in direct.module.buffers())
    direct.land(direct.draw(seed))
    got = direct.module.state_dict()
    module = bundle.get_builder("lfm2_moe")(**_kwargs(cfg))
    want = init_state_dict(module, seed)
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k
    assert direct.module.lm_head.weight is direct.module.embed_tokens.weight
    assert torch.equal(got["lm_head.weight"], got["embed_tokens.weight"])
    w = ref.init_weights(cfg, seed)
    assert sorted(w) == sorted(k for k in got if k != "lm_head.weight")
    for k, v in w.items():
        assert torch.equal(got[k], v), k
    for m in direct.module.modules():
        if isinstance(m, moe.Router):
            assert m.weight.dtype == torch.float32
            assert not any(b is m.expert_bias for b in
                           direct.module.parameters())


@pytest.mark.parametrize("seed", SEEDS)
def test_logits_loss_and_every_gradient_match_the_reference(seed):
    cfg = _cfg()
    model = _model(cfg, seed)
    w = ref.init_weights(cfg, seed)
    toks = _tokens(2)
    logits, taps = model(toks)
    assert logits.dtype == torch.float32 and set(taps) >= {"logits",
                                                           "hidden", "embed"}
    want = ref.logits(w, toks, cfg)
    assert _rel(logits.detach(), want) < 1e-4
    loss = training.lm_loss(logits, toks)
    loss.backward()
    want_loss, grads, _pairs = ref.loss_and_grads(w, toks, cfg)
    assert abs(float(loss.detach()) - want_loss) < 1e-4 * abs(want_loss)
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(ref.trainable(cfg))
    for k, g in grads.items():
        assert _rel(params[k].grad, g) < 1e-3, k


def test_given_one_selection_the_port_and_the_reference_agree():
    """The reference's `routes` (the trained-state comparison's shared
    selection): fed its own top-k (`chosen`) it computes what it computes
    alone; fed another selection (each token's experts shifted by 3), it
    still equals the port made to select the same, logits, loss and every
    gradient within the bounds above."""
    cfg = _cfg()
    w = ref.init_weights(cfg, 11)
    toks = _tokens(2)
    own = {}
    alone = ref.loss_and_grads(w, toks, cfg, chosen=own)
    assert sorted(own) == ["layers.%d.feed_forward." % i for i in (1, 2, 3)]
    assert all(e.shape == (2 * SEQ, 2) for e in own.values())
    again = ref.loss_and_grads(w, toks, cfg, routes=own)
    assert again[0] == alone[0] and again[2] == alone[2]
    assert all(torch.equal(again[1][k], g) for k, g in alone[1].items())
    shifted = {p: (e + 3) % 8 for p, e in own.items()}
    want_loss, grads, _pairs = ref.loss_and_grads(w, toks, cfg,
                                                  routes=shifted)
    assert abs(want_loss - alone[0]) > 1e-4 * abs(alone[0])
    model = _model(cfg, 11)
    order = iter([shifted[p] for p in sorted(shifted)])
    saved = moe.select_experts
    moe.select_experts = lambda scores, bias, k: next(order)
    try:
        loss = training.lm_loss(model(toks)[0], toks)
    finally:
        moe.select_experts = saved
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) < 1e-4 * abs(want_loss)
    params = dict(model.named_parameters())
    for k, g in grads.items():
        assert _rel(params[k].grad, g) < 1e-3, k


def _changed_after(cfg, t):
    """(logits of tokens, logits of tokens with every position after t
    redrawn) of a model of `cfg`."""
    model = _model(cfg, 3)
    a = _tokens(1)
    b = a.clone()
    b[:, t + 1:] = (b[:, t + 1:] + 17) % cfg["vocab_size"]
    with torch.no_grad():
        return model(a)[0], model(b)[0]


@pytest.mark.parametrize("kind", ["conv", "full_attention"])
def test_a_later_token_changes_no_earlier_logit(kind):
    cfg = _cfg(layer_types=[kind], num_dense_layers=1)
    for t in (0, 5, SEQ - 2):
        la, lb = _changed_after(cfg, t)
        assert torch.equal(la[:, :t + 1], lb[:, :t + 1]), (kind, t)
        assert not torch.equal(la[:, t + 1:], lb[:, t + 1:])


def test_a_centred_convolution_sees_the_next_token(monkeypatch):
    """The causality check can fail: a kernel centred on its token."""
    def centred(u, weight):
        v = F.conv1d(F.pad(u.transpose(1, 2), (1, 1)), weight,
                     groups=u.shape[-1])
        return v.transpose(1, 2)

    monkeypatch.setattr(lfm2, "short_conv", centred)
    la, lb = _changed_after(_cfg(layer_types=["conv"]), 5)
    assert not torch.equal(la[:, :6], lb[:, :6])


def test_short_conv_is_the_published_recurrence():
    g = torch.Generator().manual_seed(1)
    u, w = torch.randn(2, 7, 5, generator=g), torch.randn(5, 1, 3, generator=g)
    v = lfm2.short_conv(u, w)
    up = F.pad(u, (0, 0, 2, 0))
    want = sum(w[:, 0, j] * up[:, j:j + 7] for j in range(3))
    assert torch.allclose(v, want, atol=1e-6, rtol=0)


def _layer(held=8, offset=0, seed=4):
    torch.manual_seed(seed)
    m = moe.TopKExperts(16, 8, 8, 2, experts_held=held, expert_offset=offset)
    for p in (m.w1, m.w3, m.w2, m.gate.weight):
        torch.nn.init.normal_(p, std=0.3)
    torch.nn.init.normal_(m.gate.expert_bias, std=0.01)
    return m


def test_routing_selects_by_biased_score_and_weights_by_unbiased():
    m = _layer()
    x = torch.randn(40, 16)
    with torch.no_grad():
        s = torch.sigmoid(x @ m.gate.weight.t())
        m.gate.expert_bias.zero_()
        m.gate.expert_bias[5] = 2.0  # above any score gap: always selected
        expert, weight = m.route(x)
    assert (expert == 5).any(-1).all()
    want = torch.topk(s + m.gate.expert_bias, 2, dim=-1).indices
    assert torch.equal(expert, want)
    picked = s.gather(1, expert)
    assert torch.allclose(weight, picked / (picked.sum(-1, keepdim=True)
                                            + 1e-6), atol=0, rtol=1e-6)
    # the bias selected, it did not weigh: expert 5's weight is its score's
    assert not torch.allclose(weight, (s + m.gate.expert_bias).gather(
        1, expert) / (s + m.gate.expert_bias).gather(1, expert).sum(
            -1, keepdim=True))


def _dense_moe(m, x):
    """Every token through every one of its selected held experts, one
    token at a time: the arithmetic the layer must equal."""
    expert, weight = m.route(x)
    out = torch.zeros_like(x)
    for i in range(x.shape[0]):
        for j in range(expert.shape[1]):
            e = int(expert[i, j]) - m.expert_offset
            if 0 <= e < m.experts_held:
                h = F.silu(x[i] @ m.w1[e].t()) * (x[i] @ m.w3[e].t())
                out[i] += weight[i, j] * (h @ m.w2[e].t())
    return out


@pytest.mark.parametrize("load", ["spread", "all_on_two"])
def test_no_pair_is_dropped_at_any_load(load):
    m = _layer(held=4, offset=0)
    x = torch.randn(64, 16)
    if load == "all_on_two":
        with torch.no_grad():
            m.gate.expert_bias[:] = -5.0
            m.gate.expert_bias[1:3] = 5.0
    before = telemetry.counters("models.moe.")
    with torch.no_grad():
        got = m(x)
        expert, _w = m.route(x)
    after = telemetry.counters("models.moe.")
    held = int((expert < 4).sum())
    if load == "all_on_two":
        assert held == 64 * 2
    assert after["models.moe.held_pairs"] - before.get(
        "models.moe.held_pairs", 0) == held
    assert after["models.moe.absent_pairs"] - before.get(
        "models.moe.absent_pairs", 0) == 64 * 2 - held
    assert torch.allclose(got, _dense_moe(m, x), atol=1e-5, rtol=1e-5)


def test_the_expert_shares_sum_to_the_uncut_layer_and_its_reference():
    whole = _layer(held=8)
    x = torch.randn(48, 16)
    parts = []
    for i in range(4):
        share = moe.TopKExperts(16, 8, 8, 2, experts_held=2,
                                expert_offset=2 * i)
        with torch.no_grad():
            for name in ("w1", "w3", "w2"):
                getattr(share, name).copy_(
                    getattr(whole, name)[2 * i:2 * i + 2])
            share.gate.weight.copy_(whole.gate.weight)
            share.gate.expert_bias.copy_(whole.gate.expert_bias)
            parts.append(share(x))
    with torch.no_grad():
        uncut = whole(x)
    assert torch.allclose(sum(parts), uncut, atol=1e-5, rtol=1e-5)
    # the reference's expert layer over the same weights
    cfg = {"num_experts": 8, "expert_offset": 0, "num_experts_per_tok": 2,
           "norm_eps": 1e-5}
    w = {"f.w1": whole.w1.detach(), "f.w3": whole.w3.detach(),
         "f.w2": whole.w2.detach(), "f.gate.weight": whole.gate.weight.detach(),
         "f.gate.expert_bias": whole.gate.expert_bias}
    with torch.no_grad():
        want = ref._experts(ref._Ctx(w, cfg, None, False), "f.", x[None])[0]
    assert torch.allclose(uncut, want, atol=1e-5, rtol=1e-5)


def test_a_layer_with_no_held_pair_gives_its_experts_a_zero_gradient():
    m = _layer(held=2, offset=0)
    with torch.no_grad():
        m.gate.expert_bias[:2] = -100.0
    x = torch.randn(10, 16, requires_grad=True)
    out = m(x)
    assert not out.any()
    out.sum().backward()
    for w in (m.w1, m.w3, m.w2):
        assert w.grad is not None and not w.grad.any()


def test_three_adam_epoch_steps_match_the_references():
    cfg = _cfg()
    seed, lr = 11, 3e-3
    model = _model(cfg, seed)
    state = training.TrainState.create(model, training.adam(lr),
                                       device="cpu")
    toks = torch.stack([_tokens(2, seed=s) for s in (1, 2, 3)])
    state, losses = training.make_lm_train_epoch()(state, toks)
    w = ref.init_weights(cfg, seed)
    w0 = {k: v.clone() for k, v in w.items()}
    opt, want = {}, []
    for i in range(3):
        loss, grads, _pairs = ref.loss_and_grads(w, toks[i], cfg)
        want.append(loss)
        ref.adam_step(w, opt, grads, lr)
    assert torch.allclose(losses, torch.tensor(want), rtol=1e-4, atol=0)
    assert state.step == 3
    for k, p in state.module.named_parameters():
        change, want_change = p.detach() - w0[k], w[k] - w0[k]
        assert _rel(change, want_change) < 1e-3, k


def test_decoding_is_not_supported():
    model = _model(_cfg(), 0)
    with pytest.raises(NotImplementedError):
        model(_tokens(1), kvcache=[])
    with pytest.raises(NotImplementedError):
        model.decode_step(_tokens(1))


def test_the_reference_counts_causal_attention_and_routed_pairs():
    cfg = _cfg()
    d, v, s = cfg["hidden_size"], cfg["vocab_size"], SEQ
    base = ref.forward_macs(cfg, 0, s)
    assert ref.forward_macs(cfg, 10, s) - base == 10 * 3 * d * \
        cfg["moe_intermediate_size"]
    # two attention layers, 4 heads of 16: q.k and p.v over t + 1 keys
    attn = 2 * 2 * 4 * 16 * s * (s + 1) / 2
    assert ref.forward_macs(cfg, 0, s, sequences=3) == 3 * base
    assert base > attn + s * d * v


def test_the_references_fp8_control_runs_past_an_expert_no_token_chose():
    from perfbench.reference.precision import fp8_e4m3

    cfg = _cfg()
    w = ref.init_weights(cfg, 0)
    for k in w:
        if k.endswith("gate.expert_bias"):
            w[k][cfg["expert_offset"]] = -100.0  # the first held expert
    loss, grads, held = ref.loss_and_grads(w, _tokens(1), cfg, fp8_e4m3)
    assert held > 0 and torch.isfinite(torch.tensor(loss))
    assert all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.cuda
def test_the_cards_grouped_products_are_the_per_expert_loop():
    """`_grouped_swiglu_card` (`torch._grouped_mm` over zero-padded
    groups) against the per-expert loop in float32 from the same bf16
    inputs, at the published widths (2048, 1792), on ragged groups: empty
    ones and sizes off the 16-row alignment.  The card's path rounds h
    and y to bf16 (2^-8 relative at most an element), so the norm of the
    difference is under 1e-2 of the result's, forward and backward; an
    expert's rows run with another expert's slabs would differ by ~1.4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(5)
    sizes = [0, 1, 15, 16, 17, 300, 0, 33]
    dim, ffn = 2048, 1792

    def draw(*shape):
        t = torch.randn(*shape, generator=g) * shape[-1] ** -0.5
        return t.to("cuda", torch.bfloat16).requires_grad_()

    rows, w1, w3 = draw(sum(sizes), dim), draw(8, ffn, dim), draw(8, ffn, dim)
    w2 = draw(8, dim, ffn)
    leaves = (rows, w1, w3, w2)
    up = torch.randn(sum(sizes), dim, generator=g).cuda()
    got = moe._grouped_swiglu_card(rows, sizes, w1, w3, w2)
    got_grads = torch.autograd.grad(got.float(), leaves, up)
    m = moe.TopKExperts(dim, ffn, 8, 2).cuda()
    with torch.no_grad():
        for name, w in zip(("w1", "w3", "w2"), (w1, w3, w2)):
            getattr(m, name).copy_(w.float())
    x = rows.detach().float().requires_grad_()
    want = m._grouped_swiglu(x, sizes)   # float32 takes the loop
    want_grads = torch.autograd.grad(want, (x, m.w1, m.w3, m.w2), up)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(got.float(), want) < 1e-2
    for name, a, b in zip(("rows", "w1", "w3", "w2"), got_grads, want_grads):
        assert _rel(a.float(), b) < 1e-2, name
    for a in got_grads[1:]:   # the empty groups' slabs get no gradient
        assert not a[0].any() and not a[6].any()
