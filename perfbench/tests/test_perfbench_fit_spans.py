"""The readers of the program's fit spans (`fit_setup_share`,
`step_device_ms`, `epoch_feed_share`) over a fabricated span ring: set-up's
warm fit, the window's fits and the traced fit, and rings that lack what
they read."""
import itertools

import pytest

from mmlspark_tpu_torch.core import telemetry
from perfbench.harness import runner, spec
from perfbench.tests import tiny

READERS = ("fit_setup_share.finetune", "step_device_ms.finetune",
           "epoch_feed_share.finetune")
_ids = itertools.count()


def _span(name, trace, wall, parent="p", **attrs):
    return {"name": name, "trace_id": trace, "span_id": str(next(_ids)),
            "parent_id": parent, "t_start": 0.0, "wall_s": wall,
            "attrs": attrs}


def _fit(fit_s, epochs_s, waits_s, steps_s, device=True):
    """One fit's spans in completion order: each epoch's feed waits, step
    spans and device steps, the epoch, then the root."""
    trace = "t%d" % next(_ids)
    out = []
    for epoch_s in epochs_s:
        out += [_span("feed.next", trace, w) for w in waits_s]
        out += [_span("training.step", trace, 0.001) for _ in steps_s]
        if device:
            out += [_span("training.step.device", trace, s) for s in steps_s]
        out.append(_span("deep_vision.epoch", trace, epoch_s))
    out.append(_span("deep_vision.fit", trace, fit_s, parent=None,
                     epochs=len(epochs_s)))
    return out


WARM = _fit(100.0, [1.0, 1.0], [0.9], [0.5, 0.5])
WINDOW = [_fit(10.0, [3.0, 3.0], [0.5, 0.25], [0.05, 0.06]),
          _fit(12.0, [3.0, 3.0], [0.5, 0.25], [0.05, 0.07]),
          _fit(14.0, [3.0, 3.0], [0.5, 0.25], [0.06, 0.08])]
TRACED = _fit(50.0, [2.0, 2.0], [1.5], [0.9, 0.9])


def _view(n_calls, n_traced=1):
    wl, cfg, mix = tiny.finetune_parts()
    ctx = runner.Context(wl, cfg, mix, {}, 1, "cpu", True)
    calls = [runner.Call(i, i + 1.0, {"steps": 4}) for i in range(n_calls)]
    return runner.View(ctx, calls, {}, None, [{"steps": 4}] * n_traced)


def _read(monkeypatch, ring, view):
    monkeypatch.setattr(telemetry, "recent_spans", lambda n=None: list(ring))
    return {name: spec.metric_reader(name).read(view) for name in READERS}


def test_the_readers_read_the_windows_fits_alone(monkeypatch):
    other = [_span("serving.request", "x", 5.0, parent=None)]
    ring = other + WARM + sum(WINDOW, []) + TRACED
    got = _read(monkeypatch, ring, _view(3))
    # (36 s of fits - 18 s of epochs) / 36 s
    assert got["fit_setup_share.finetune"] == pytest.approx(50.0)
    # 6 epochs waited 0.75 s each over 18 s of epochs
    assert got["epoch_feed_share.finetune"] == pytest.approx(25.0)
    # the median of the window's 12 device steps, in ms
    assert got["step_device_ms.finetune"] == pytest.approx(60.0)


def test_with_fewer_fits_than_the_window_and_the_traced_run(monkeypatch):
    # the ring has lost the warm fit and the first window fit's root
    ring = [s for s in sum(WINDOW, []) if s is not WINDOW[0][-1]] + TRACED
    assert set(_read(monkeypatch, ring, _view(3)).values()) == {None}


def test_a_fit_without_its_epochs_reads_nothing(monkeypatch):
    ring = WARM + [s for s in sum(WINDOW, []) if s is not WINDOW[1][-2]] \
        + TRACED
    assert set(_read(monkeypatch, ring, _view(3)).values()) == {None}


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    ring = [_span("feed.transfer", "x", 0.1)] * 20
    assert set(_read(monkeypatch, ring, _view(3)).values()) == {None}


def test_no_device_steps_on_a_cpu(monkeypatch):
    window = [_fit(10.0, [3.0, 3.0], [0.5, 0.25], [0.05], device=False)
              for _ in range(2)]
    got = _read(monkeypatch, WARM + sum(window, []) + TRACED, _view(2))
    assert got["step_device_ms.finetune"] is None
    assert got["fit_setup_share.finetune"] == pytest.approx(40.0)
