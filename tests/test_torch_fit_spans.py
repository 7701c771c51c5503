"""The spans of `DeepVisionClassifier.fit` (models/deep_vision.py) on the
CPU: one trace a fit with its layers as named children (the direct
init's draw on its own thread among them), a backbone the init's walk
does not cover on the module path, an error of the draw raised from the
fit, a step span a step, only rows of another size through the resize
pipeline, the arithmetic that places device-timed steps on the host
clock, a trace over the per-trace cap that keeps its root and counts its
drops, and the fit's span beside the profiler's range of the same
name."""
import numpy as np
import pytest
import torch
from torch import nn

from mmlspark_tpu_torch.core import telemetry
from mmlspark_tpu_torch.core.schema import Table
from mmlspark_tpu_torch.core.telemetry import device as device_obs
from mmlspark_tpu_torch.core.telemetry import spans as port_spans
from mmlspark_tpu_torch.models import bundle
from mmlspark_tpu_torch.models import deep_vision as DV
from mmlspark_tpu_torch.models.convnets import convnet_cifar
from mmlspark_tpu_torch.models.training import (StepEvents,
                                                device_step_intervals)

torch.set_num_threads(2)

CHILDREN = ("deep_vision.decode", "deep_vision.rows", "deep_vision.build",
            "deep_vision.draw", "deep_vision.init", "deep_vision.train_state",
            "deep_vision.bundle")


def _table(n, seed=0, other=()):
    """n labelled 32x32 BGR rows; the rows at positions `other` 40x36."""
    rng = np.random.default_rng(seed)
    col = np.empty(n, object)
    for i in range(n):
        hw = (40, 36) if i in other else (32, 32)
        col[i] = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    labels = np.asarray(["cat", "dog"] * (n // 2))
    return Table({"image": col, "label": labels})


def _fit(table, epochs=2, batch_size=8):
    return DV.DeepVisionClassifier(backbone="convnet_cifar", epochs=epochs,
                                   batch_size=batch_size, seed=3,
                                   device="cpu").fit(table)


def _last_fit_trace():
    roots = [s for s in telemetry.recent_spans()
             if s["name"] == "deep_vision.fit"]
    assert roots
    root = roots[-1]
    return root, telemetry.get_trace(root["trace_id"])


def test_a_fit_records_one_trace_of_its_layers():
    model = _fit(_table(24))
    root, spans = _last_fit_trace()
    assert root["parent_id"] is None
    assert root in spans  # indexed under its trace
    assert {s["trace_id"] for s in spans} == {root["trace_id"]}
    assert root["attrs"] == {"backbone": "convnet_cifar", "rows": 24,
                             "epochs": 2, "steps": 6}
    under_root = [s["name"] for s in spans
                  if s["parent_id"] == root["span_id"]]
    for name in CHILDREN:
        assert under_root.count(name) == 1, name
    init = next(s for s in spans if s["name"] == "deep_vision.init")
    assert init["attrs"] == {"init_path": "direct"}
    # the draw ran on its own thread, before the init landed it
    draw = next(s for s in spans if s["name"] == "deep_vision.draw")
    floats = sum(t.size for t in model.bundle.state_dict.values()
                 if t.dtype.kind == "f")
    assert draw["attrs"] == {"bytes": 4 * floats}
    assert draw["tid"] != root["tid"]
    assert draw["t_start"] + draw["wall_s"] <= \
        init["t_start"] + init["wall_s"] + 1e-3
    epochs = [s for s in spans if s["name"] == "deep_vision.epoch"]
    assert len(epochs) == 2 == len(model.loss_history)
    assert all(e["parent_id"] == root["span_id"] for e in epochs)
    epoch_ids = {e["span_id"] for e in epochs}
    steps = [s for s in spans if s["name"] == "training.step"]
    assert len(steps) == 6
    assert all(s["parent_id"] in epoch_ids for s in steps)
    waits = [s for s in spans if s["name"] == "feed.next"]
    assert waits and all(s["parent_id"] in epoch_ids for s in waits)
    # the assemble workers' spans land in the fit's trace too
    assert any(s["name"] == "pipeline.assemble" for s in spans)
    # no events on a CPU device, so no device-timed steps
    assert not any(s["name"] == "training.step.device" for s in spans)
    assert not any(s["name"] == "deep_vision.checkpoint" for s in spans)
    assert sum(e["wall_s"] for e in epochs) <= root["wall_s"]


def test_only_rows_of_another_size_go_through_the_resize_pipeline():
    other = set(range(1, 48, 3))
    assert len(other) == 16
    table = _table(48, seed=1, other=other)
    torch.manual_seed(0)  # the convnet's dropout
    mixed = _fit(table, epochs=1)
    root, spans = _last_fit_trace()
    rows = next(s for s in spans if s["name"] == "deep_vision.rows")
    assert rows["attrs"] == {"resized": 16}
    resized = [s for s in spans if s["name"] == "pipeline.resize"]
    assert len(resized) == 16
    assert all(s["parent_id"] == rows["span_id"] for s in resized)
    # the same pixels in the same order: a fit on rows resized beforehand
    # (none through the pipeline) gives the same losses
    col = np.empty(48, object)
    for i, a in enumerate(table["image"]):
        col[i] = DV._to_hw(a, 32, 32)
    torch.manual_seed(0)
    same = _fit(Table({"image": col, "label": table["label"]}), epochs=1)
    _root, spans = _last_fit_trace()
    assert next(s for s in spans
                if s["name"] == "deep_vision.rows")["attrs"] == {"resized": 0}
    assert not any(s["name"] == "pipeline.resize" for s in spans)
    assert same.loss_history == mixed.loss_history


class _ScaledConvNet(nn.Module):
    """convnet_cifar with a bare scale on its logits: a parameter that
    the init's walk does not write."""

    def __init__(self, num_classes=10, image_size=(32, 32)):
        super().__init__()
        self.net = convnet_cifar(num_classes, image_size)
        self.scale = nn.Parameter(torch.full((), 0.5))

    def forward(self, x):
        logits, taps = self.net(x)
        return logits * self.scale, taps


def test_a_backbone_the_walk_does_not_cover_fits_on_the_module_path(
        monkeypatch):
    monkeypatch.setitem(bundle._BUILDERS, "test_scaled_convnet",
                        _ScaledConvNet)
    model = DV.DeepVisionClassifier(
        backbone="test_scaled_convnet", epochs=1, batch_size=8, seed=3,
        device="cpu").fit(_table(16))
    _root, spans = _last_fit_trace()
    init = next(s for s in spans if s["name"] == "deep_vision.init")
    assert init["attrs"] == {"init_path": "module"}
    assert not any(s["name"] == "deep_vision.draw" for s in spans)
    assert len(model.loss_history) == 1
    assert np.isfinite(model.loss_history[0])


def test_an_error_in_the_draw_reaches_the_caller_of_fit(monkeypatch):
    def fails(self, seed, pin_memory=False):
        raise RuntimeError("the draw failed")

    monkeypatch.setattr(bundle.DirectInit, "draw", fails)
    with pytest.raises(RuntimeError, match="the draw failed"):
        _fit(_table(16), epochs=1)
    root, spans = _last_fit_trace()
    assert root["error"] == "RuntimeError"
    draw = next(s for s in spans if s["name"] == "deep_vision.draw")
    assert draw["error"] == "RuntimeError"
    assert not any(s["name"] == "deep_vision.epoch" for s in spans)


def test_device_step_intervals_end_at_the_anchor():
    # steps start on the device at 0, 10 and 25 ms and run 9, 12 and
    # 5 ms; the anchor event completes at 30 ms, host time 1000 s
    starts, durations = [0.0, 10.0, 25.0], [9.0, 12.0, 5.0]
    anchor_ms, anchor_s = 30.0, 1000.0
    got = device_step_intervals(anchor_s, [anchor_ms - s for s in starts],
                                durations)
    assert [d for _t, d in got] == pytest.approx([0.009, 0.012, 0.005])
    assert [t for t, _d in got] == pytest.approx(
        [anchor_s - 0.030, anchor_s - 0.020, anchor_s - 0.005])
    for (t0, d0), (t1, _d1) in zip(got, got[1:]):
        assert t0 < t1 and t0 + d0 <= t1 + 1e-12
    assert got[-1][0] + got[-1][1] == pytest.approx(anchor_s)
    assert device_step_intervals(anchor_s, [], []) == []


def test_step_events_record_nothing_on_a_cpu_device():
    events = StepEvents(torch.device("cpu"))
    before = len(telemetry.recent_spans())
    with telemetry.span("test.epoch"):
        for _ in range(3):
            with events.step():
                pass
        events.anchor()
        events.flush(1000.0)
    names = [s["name"] for s in telemetry.recent_spans()[before:]]
    assert names == ["test.epoch"]


def test_a_trace_over_the_cap_keeps_its_root_and_counts_its_drops(
        monkeypatch):
    monkeypatch.setattr(port_spans, "MAX_SPANS_PER_TRACE", 8)
    dropped = telemetry.counters("telemetry.spans.dropped").get(
        "telemetry.spans.dropped", 0)
    with telemetry.span("test.root") as root:
        ctx = telemetry.current_context()
        for i in range(12):
            telemetry.record_span("test.child", ctx, 0.001, i=i)
    spans = telemetry.get_trace(root.trace_id)
    assert len(spans) == 8
    assert spans[-1]["name"] == "test.root"
    assert spans[-1]["parent_id"] is None
    # children 0-6 kept, 7 gave its place to the root, 8-11 dropped
    assert [s["attrs"]["i"] for s in spans[:-1]] == list(range(7))
    assert telemetry.counters("telemetry.spans.dropped")[
        "telemetry.spans.dropped"] == dropped + 5


def test_a_short_trace_counts_no_drop():
    dropped = telemetry.counters("telemetry.spans.dropped").get(
        "telemetry.spans.dropped", 0)
    with telemetry.span("test.root"):
        telemetry.record_span("test.child", telemetry.current_context(),
                              0.001, t_start=5.0)
    assert telemetry.counters("telemetry.spans.dropped").get(
        "telemetry.spans.dropped", 0) == dropped
    child = [s for s in telemetry.recent_spans()
             if s["name"] == "test.child"][-1]
    assert child["t_start"] == 5.0 and child["wall_s"] == 0.001


def test_the_profilers_fit_range_and_the_span_agree():
    from torch.profiler import ProfilerActivity, profile

    hook = port_spans.get_annotation_hook()
    try:
        assert device_obs.enable_device_annotations()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _fit(_table(16), epochs=1)
    finally:
        port_spans.set_annotation_hook(*hook)
    root, spans = _last_fit_trace()
    ranges = [e for e in prof.events() if e.name == "deep_vision.fit"]
    assert len(ranges) == 1
    range_s = ranges[0].time_range.elapsed_us() * 1e-6
    assert abs(range_s - root["wall_s"]) < 0.005
    names = {e.name for e in prof.events()}
    assert {"deep_vision.epoch", "deep_vision.build", "feed.next",
            "training.step"} <= names
