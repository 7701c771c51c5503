"""The trace reduction on a synthetic trace: busy time as the union of
device intervals, idle gaps named by the host's innermost event, kernel
time by name, and the readers that use them."""
import types

import pytest
from torch.autograd import DeviceType

from perfbench.harness import runner, spec, trace
from perfbench.tests import tiny


def _ev(name, start, end, dev=False, thread=1, user=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        thread=0 if dev else thread, is_user_annotation=user)


EVENTS = [
    _ev(trace.WINDOW_SPAN, 1000, 11000, user=True),
    _ev("perfbench.transform", 1000, 11000, user=True),
    _ev("pipeline.assemble", 1000, 3000, user=True),
    _ev("aten::copy_", 1500, 2500),
    _ev("aten::conv2d", 3000, 4000),
    # device: two overlapping kernels, a copy, one affine kernel
    _ev("conv_kernel_a", 3000, 5000, dev=True),
    _ev("conv_kernel_b", 4000, 6000, dev=True),
    _ev("Memcpy HtoD", 7000, 8000, dev=True),
    _ev("affine_resample_tile_kernel<uchar>", 9000, 10000, dev=True),
    _ev("flash_kernel_outside_the_window", 20000, 21000, dev=True),
    _ev("aten::empty", 6500, 6900, thread=2),
    # the profiler's device-side range of a host span: not an operation
    _ev("perfbench.transform", 2000, 10500, dev=True, user=True),
]


def test_busy_is_the_union_inside_the_window():
    s = trace.summarize(EVENTS)
    assert s.window_s == pytest.approx(0.010)
    # [3000, 6000] + [7000, 8000] + [9000, 10000] = 5000 us
    assert s.busy_s == pytest.approx(0.005)
    assert s.kernel_seconds(("affine_resample",)) == (pytest.approx(0.001), 1)
    assert s.kernel_seconds(("flash",)) == (0, 0)


def test_idle_gaps_are_named_by_the_host():
    s = trace.summarize(EVENTS)
    gaps = dict(s.idle_gaps)
    # [1000, 3000]: the main thread's innermost event at its middle
    assert gaps["aten::copy_"] == pytest.approx(0.002)
    # [6000, 7000], [8000, 9000], [10000, 11000]: only the call's span
    assert gaps["perfbench.transform"] == pytest.approx(0.003)
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)
    b = s.breakdown()
    assert b["device_ops"][0][0] in ("conv_kernel_a", "conv_kernel_b")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_idle_share_and_resample_roofline_read_the_trace():
    s = trace.summarize(EVENTS)
    wl, cfg, mix = tiny.featurize_parts()
    ctx = runner.Context(wl, dict(cfg, image_size=[224, 224]), mix, {}, 1,
                         "cpu", True)
    traced = [{"rows": 2, "shapes": {(375, 500, 3): 2}}]
    view = runner.View(ctx, [], {}, s, traced)
    assert spec.metric_reader("idle_share.featurize").read(view) == \
        pytest.approx(50.0)
    roof = spec.metric_reader("resample_roofline.featurize")
    want = 100 * 2 * (375 * 500 * 3 + 224 * 224 * 3 * 4) / 3.35e12 / 0.001
    assert roof.read(view) == pytest.approx(want)


def test_a_reader_with_nothing_to_read_returns_nothing():
    s = trace.summarize(EVENTS[:5])     # no device operation at all
    wl, cfg, mix = tiny.finetune_parts()
    ctx = runner.Context(wl, cfg, mix, {}, 1, "cpu", True)
    view = runner.View(ctx, [], {}, s, [{"steps": 4}])
    for name in ("attn_fwd_roofline.finetune", "attn_bwd_roofline.finetune",
                 "idle_share.finetune", "mfu.finetune"):
        assert spec.metric_reader(name).read(view) is None


@pytest.mark.parametrize("driver", ["featurize", "finetune"])
def test_a_traced_run_reports_per_layer_metrics_and_undoes_its_spans(driver):
    from mmlspark_tpu_torch.io import feed, pipeline
    from mmlspark_tpu_torch.models import deep_vision, torch_model, training

    before = (torch_model.TorchModel.__dict__["run_grouped"],
              feed.DeviceFeed.__dict__["run"],
              pipeline.HostPipeline.__dict__["run"],
              deep_vision._decode_column,
              training.TrainState.__dict__["create"],
              training.TrainState.__dict__["apply_gradients"],
              training._per_example_ce)
    parts, limits = ((tiny.featurize_parts(), tiny.FEATURIZE_LIMITS)
                     if driver == "featurize" else
                     (tiny.finetune_parts(), tiny.FINETUNE_LIMITS))
    rc, result, err = tiny.run(parts, limits, trace=True)
    assert rc == 0 and result["correct"], err[-2000:]
    per_layer = {m["name"] for m in spec.metrics_for(
        tiny.BENCH_ALL, "per_layer", parts[0]["name"])}
    assert set(result["metrics"]) <= per_layer
    # on the CPU the readers of the device find nothing; the host's do
    assert f"mfu.{driver}" in result["metrics"]
    assert not any("roofline" in m or "idle" in m for m in result["metrics"])
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"
    after = (torch_model.TorchModel.__dict__["run_grouped"],
             feed.DeviceFeed.__dict__["run"],
             pipeline.HostPipeline.__dict__["run"],
             deep_vision._decode_column,
             training.TrainState.__dict__["create"],
             training.TrainState.__dict__["apply_gradients"],
             training._per_example_ce)
    assert after == before
