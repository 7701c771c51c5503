"""The yardstick's arithmetic against hand counts: model FLOPs, the
kernels' least bytes and FLOPs, the window's rate and tail."""
import pytest

from perfbench.harness import device, runner, spec
from perfbench.tests import tiny

RESNET50 = spec.config(tiny.BENCH_ALL, "resnet50", tiny.ROOT)
VIT_B16 = spec.config(tiny.BENCH_ALL, "vit_b16", tiny.ROOT)


def test_resnet50_forward_is_4_1_gmac():
    # torchvision's resnet50 at 224x224: 4.09 GMAC (convolutions + fc)
    macs = spec.family_module(RESNET50).forward_macs(RESNET50)
    assert macs == pytest.approx(4.09e9, rel=0.01)


def test_vit_b16_forward_by_hand():
    s, e, m = 196, 768, 3072
    layer = s * e * 3 * e + 2 * s * s * e + s * e * e + 2 * s * e * m
    want = s * e * 3 * 16 * 16 + 12 * layer + e * 100
    macs = spec.family_module(VIT_B16).forward_macs(VIT_B16)
    assert macs == want
    assert macs == pytest.approx(17.5e9, rel=0.01)


def test_resample_bytes_by_hand():
    mod = spec.metric_reader("resample_roofline.featurize")
    # a 375x500 BGR uint8 image read once, 224x224x3 float32 written once
    assert mod.min_bytes(375, 500, 3, 224, 224) == 562500 + 602112


def test_attention_bounds_by_hand():
    fwd = spec.metric_reader("attn_fwd_roofline.finetune")
    bwd = spec.metric_reader("attn_bwd_roofline.finetune")
    b, s, h, d = 128, 196, 12, 64
    n = b * s * h * d
    # forward: q, k, v in bf16 and the f32 output; 4 B H S^2 D FLOPs
    assert fwd.least_seconds(b, s, h, d) == pytest.approx(
        max(10 * n / device.HBM_BYTES_PER_S,
            4 * b * h * s * s * d / device.BF16_FLOPS))
    # at 196 tokens both are bound by bytes
    assert 10 * n / device.HBM_BYTES_PER_S > \
        4 * b * h * s * s * d / device.BF16_FLOPS
    assert bwd.least_seconds(b, s, h, d) == pytest.approx(
        max(16 * n / device.HBM_BYTES_PER_S,
            8 * b * h * s * s * d / device.BF16_FLOPS))


def _view(calls, mix=None, cfg=RESNET50):
    wl = {"name": "resnet50.featurize", "chips": 1}
    ctx = runner.Context(wl, cfg, mix or {"batch_size": 64}, {}, 1, "cpu",
                         False)
    return runner.View(ctx, calls, {}, None, [])


def test_rate_and_tail_over_all_calls():
    # 20 calls of 512 rows: 100 ms each, one of 300 ms; back to back
    t, calls = 0.0, []
    for i in range(20):
        d = 0.3 if i == 7 else 0.1
        calls.append(runner.Call(t, t + d, {"rows": 512}))
        t += d
    view = _view(calls)
    assert view.window_s == pytest.approx(2.2)
    rate = spec.metric_reader("images_per_s").read(view)
    assert rate == pytest.approx(20 * 512 / 2.2)
    p95 = spec.metric_reader("partition_p95_ms").read(view)
    # 95th percentile of 19 x 100 ms and 1 x 300 ms, linear between the
    # 19th and 20th order statistics: 100 + 0.05 * 200
    assert p95 == pytest.approx(110.0)


def test_step_time_counts_the_whole_fit():
    calls = [runner.Call(0.0, 4.0, {"rows": 8192, "steps": 64}),
             runner.Call(4.0, 7.2, {"rows": 8192, "steps": 64})]
    view = _view(calls, {"batch_size": 128}, VIT_B16)
    assert spec.metric_reader("train_step_ms").read(view) == \
        pytest.approx(7.2 / 128 * 1e3)
    mfu = spec.metric_reader("mfu.finetune").read(view)
    flops = 6 * spec.family_module(VIT_B16).forward_macs(VIT_B16) * 128 * 128
    assert mfu == pytest.approx(100 * flops / 7.2 / device.BF16_FLOPS)
