"""The port's device telemetry (mmlspark_tpu_torch/core/telemetry/device.py)
and the hooks that came with it: the counterparts of
tests/test_device_obs.py where they apply to the port — the compile
sentry over kernel builds and watched step sites, the device-memory
gauges (passive on a process that never initialised CUDA; the card test
holds them against `torch.cuda.memory_stats`), the Chrome-trace export,
the snapshot meta block, the report tools over the port's snapshots,
the metric-name lint, the serving debug endpoints — then the annotation
hook under a `torch.profiler` run, a recording lock factory and a flow
sanitizer installed through the port's `set_lock_factory` /
`set_sanitizer`, the ascii renderers against the JAX package's, and
`render_fleet_report` / `render_incident` over the port's merged
snapshots.  The bench.py / perf_gate tests of that file read the JAX
package's benchmark records and have no counterpart here.
"""
import importlib.util
import json
import os
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core import flow
from mmlspark_tpu_torch.core import telemetry
from mmlspark_tpu_torch.core.telemetry import device as device_obs
from mmlspark_tpu_torch.core.telemetry import spans as port_spans
from mmlspark_tpu_torch.utils import sync

ROOT = Path(__file__).resolve().parent.parent


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def sentry():
    s = telemetry.track_compiles()
    s.reset()
    telemetry.reset_counters("xla.")
    yield s
    s.reset()
    telemetry.reset_counters("xla.")


# ------------------------------------------------------------ compile sentry

def test_hot_path_recompile_flagged_and_shape_named(sentry):
    """Warm one shape, declare warmup over, then a second shape: the
    hot_path counters move and the log_verb record names the shape."""
    telemetry.clear_records()
    f = telemetry.watch_compiles(lambda x: x * 2.0, name="test.fn")
    f(torch.ones(4))  # warmup: a new signature, expected
    assert telemetry.counters("xla.compile.hot_path") == {}
    assert telemetry.counters("xla.compile.count")["xla.compile.count"] == 1

    sentry.end_warmup()
    assert not sentry.in_warmup
    f(torch.ones(4))  # a signature already seen
    assert telemetry.counters("xla.compile.hot_path") == {}

    f(torch.ones(8))  # NEW shape in steady state
    hot = telemetry.counters("xla.compile.hot_path")
    assert hot == {"xla.compile.hot_path": 1,
                   "xla.compile.hot_path.test.fn": 1}
    recs = [r for r in telemetry.recent_records()
            if r.get("method") == "hot_path_recompile"]
    assert recs and recs[-1]["fn"] == "test.fn"
    assert recs[-1]["shape"] == "float32[8]"
    telemetry.clear_records()


def test_compile_count_latency_and_span(sentry, tmp_path, monkeypatch):
    """A kernel build (ops/_build.py's nvcc step, its compiler faked
    here) lands in xla.compile.count, the latency histogram and — inside
    a trace — as an xla.compile child span of the caller."""
    from mmlspark_tpu_torch.ops import _build

    def fake_run(cmd, **_kw):
        out = cmd[cmd.index("-o") + 1]
        Path(out).write_bytes(b"\x7fELF")
        return type("P", (), {"returncode": 0, "stdout": "", "stderr": ""})

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    target = str(tmp_path / "libflash_attention_fwd-test.so")
    with telemetry.span("outer.dispatch") as sp:
        _build._compile("nvcc", "flash_attention_fwd", target)
    assert sentry.listener_active
    assert telemetry.counters("xla.compile.count")["xla.compile.count"] == 1
    snap = telemetry.export_snapshot(include_spans=False)
    assert snap["histograms"]["xla.compile.latency"]["count"] >= 1
    spans = telemetry.get_trace(sp.trace_id)
    build = [r for r in spans if r["name"] == "xla.compile"]
    assert build and build[0]["attrs"]["kernel"] == \
        "csrc/flash_attention_fwd.cu"
    assert build[0]["attrs"]["phase"] == "warmup"
    # in steady state a build is a hot-path compile
    sentry.end_warmup()
    device_obs.note_build("native/host", 0.01)
    assert telemetry.counters("xla.compile.hot_path") == {
        "xla.compile.hot_path": 1}


def test_warmup_compiles_not_flagged(sentry):
    f = telemetry.watch_compiles(lambda x: x - 1.0, name="test.warm")
    with sentry.warmup():
        f(torch.ones(5))
        device_obs.note_build("csrc/x.cu", 0.0)
        assert telemetry.counters("xla.compile.hot_path") == {}
    assert not sentry.in_warmup  # warmup() exit re-arms flagging
    sentry.reset()
    assert sentry.in_warmup


def test_watch_compiles_passes_through_the_callable(sentry):
    class Step:
        calls = 0

        def __call__(self, x):
            Step.calls += 1
            return x * x

        def lower(self):
            return "lowered"

    f = telemetry.watch_compiles(Step(), name="test.sq")
    assert torch.equal(f(torch.full((2,), 3.0)), torch.full((2,), 9.0))
    assert f.lower() == "lowered" and f.__wrapped__.calls == 1
    assert "test.sq" in repr(f)


def test_step_sites_are_watched_under_the_jax_packages_names():
    from mmlspark_tpu_torch.models import training as PT
    from mmlspark_tpu_torch.ops.image_stages import ImageTransformer

    for fn, name in ((PT.make_train_step(4), "training.train_step"),
                     (PT.make_train_epoch(4), "training.train_epoch"),
                     (PT.make_lm_train_epoch(), "training.lm_train_epoch"),
                     (PT.make_eval_step(), "training.eval_step")):
        assert isinstance(fn, device_obs._WatchedFunction)
        assert fn._name == name
    stage = ImageTransformer(device="cpu").flip()
    assert stage._watched_group()._name == "image_stages.ImageTransformer"


# ------------------------------------------------------------- memory gauges

def test_sample_device_memory_graceful_on_cpu():
    """A process that never initialised CUDA samples nothing: {} and no
    HBM gauge written — a scrape must not be what claims a card."""
    assert not torch.cuda.is_initialized()
    before = telemetry.export_snapshot(include_spans=False)["gauges"]
    assert device_obs.sample_device_memory() == {}
    after = telemetry.export_snapshot(include_spans=False)["gauges"]
    assert after.get("device.hbm.bytes_in_use") == \
        before.get("device.hbm.bytes_in_use")


class _FakeCuda:
    """torch.cuda as the sampler reads it: two cards, the second without
    allocator statistics."""

    def __init__(self):
        self.calls = 0

    def device_count(self):
        return 2

    def memory_stats(self, d):
        self.calls += 1
        if d == 1:
            return {}
        return {"allocated_bytes.all.current": 1000,
                "allocated_bytes.all.peak": 5000,
                "allocation.all.current": 7}

    def mem_get_info(self, d):
        return (300, 800)


def test_gauges_are_the_allocator_statistics(monkeypatch):
    fake = _FakeCuda()
    monkeypatch.setattr(device_obs, "_cuda_if_initialized", lambda: fake)
    out = device_obs.sample_device_memory()
    # card 0 from memory_stats, card 1 from mem_get_info (total - free)
    assert out == {"hbm_bytes_in_use": 1000 + 500,
                   "hbm_peak_bytes": 5000 + 500, "live_buffer_count": 7}
    gauges = telemetry.export_snapshot(include_spans=False)["gauges"]
    assert gauges["device.hbm.bytes_in_use"] == 1500
    assert gauges["device.hbm.peak_bytes"] == 5500
    assert gauges["device.live_buffer_count"] == 7


def test_memory_sampler_thread(monkeypatch):
    fake = _FakeCuda()
    monkeypatch.setattr(device_obs, "_cuda_if_initialized", lambda: fake)
    sampler = device_obs.start_memory_sampler(interval_s=0.01)
    try:
        time.sleep(0.08)
    finally:
        sampler.stop()
    assert sampler.samples >= 2 and fake.calls >= 2
    with device_obs.MemorySampler(0.01) as s:
        time.sleep(0.03)
    assert s.samples >= 1


def test_sample_passive_without_cuda(monkeypatch):
    monkeypatch.setattr(device_obs, "_cuda_if_initialized", lambda: None)
    assert device_obs.sample_device_memory() == {}


# ------------------------------------------------------- chrome trace export

def test_render_chrome_trace_unit_roundtrip():
    telemetry.clear_spans()
    with telemetry.span("client.call") as root:
        with telemetry.span("server.handle"):
            with telemetry.span("batcher.run"):
                pass
    doc = json.loads(json.dumps(telemetry.render_chrome_trace()))
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M" and evs[0]["name"] == "process_name"
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"client.call", "server.handle",
                                      "batcher.run"}
    for e in xs:
        assert e["dur"] >= 0 and e["pid"] == os.getpid()
        assert e["args"]["trace_id"] == root.trace_id
    by_name = {e["name"]: e for e in xs}
    assert by_name["server.handle"]["args"]["parent_id"] == \
        by_name["client.call"]["args"]["span_id"]
    assert by_name["batcher.run"]["args"]["parent_id"] == \
        by_name["server.handle"]["args"]["span_id"]


def test_chrome_trace_attrs_hardened():
    telemetry.clear_spans()
    with telemetry.span("weird.span", arr=np.zeros(3), t=torch.zeros(2),
                        dt=np.dtype("float32"), ok=7):
        pass
    snap = telemetry.export_snapshot()
    json.dumps(snap)
    rec = [s for s in snap["spans"] if s["name"] == "weird.span"][-1]
    assert rec["attrs"]["ok"] == 7
    assert isinstance(rec["attrs"]["arr"], str)
    assert isinstance(rec["attrs"]["t"], str)
    doc = telemetry.render_chrome_trace()
    json.dumps(doc)
    ev = [e for e in doc["traceEvents"] if e.get("name") == "weird.span"][-1]
    assert isinstance(ev["args"]["arr"], str) and ev["args"]["ok"] == 7
    telemetry.clear_spans()


def test_export_snapshot_meta():
    snap = telemetry.export_snapshot(timestamp="2026-08-05T12:00:00Z")
    meta = snap["meta"]
    assert meta["timestamp"] == "2026-08-05T12:00:00Z"
    assert meta["pid"] == os.getpid()
    assert meta["uptime_s"] >= 0
    # CUDA never initialised here: no backend facts are claimed
    assert meta.get("backend") is None and meta.get("device_count") is None
    assert telemetry.export_snapshot()["meta"]["timestamp"] is None


def test_obs_report_prints_meta_header():
    obs_report = _load_tool("obs_report")
    snap = telemetry.export_snapshot(timestamp="2026-08-05T12:00:00Z",
                                     include_spans=False)
    text = obs_report.render_report(snap)
    assert "== snapshot meta ==" in text
    assert "timestamp = 2026-08-05T12:00:00Z" in text
    assert f"pid = {os.getpid()}" in text


def test_obs_report_chrome_out(tmp_path):
    obs_report = _load_tool("obs_report")
    telemetry.clear_spans()
    with telemetry.span("report.span"):
        pass
    snap_file = tmp_path / "snap.json"
    snap_file.write_text(json.dumps(telemetry.export_snapshot(),
                                    default=repr))
    chrome_file = tmp_path / "chrome.json"
    assert obs_report.main([str(snap_file), "--chrome-out",
                            str(chrome_file)]) == 0
    doc = json.loads(chrome_file.read_text())
    assert any(e.get("name") == "report.span" for e in doc["traceEvents"])
    telemetry.clear_spans()


# ------------------------------------------- sanitize-collision metrics lint

def test_real_declared_metrics_have_no_collisions():
    from mmlspark_tpu_torch.core.telemetry.exposition import sanitize_name
    from mmlspark_tpu_torch.core.telemetry.metrics import DECLARED_METRICS

    names = list(DECLARED_METRICS)
    assert "xla.compile.hot_path" in names
    assert "device.hbm.bytes_in_use" in names
    sanitized = [sanitize_name(n) for n in names]
    assert len(set(sanitized)) == len(sanitized)


def test_device_and_dist_rows_are_the_jax_packages():
    from mmlspark_tpu.core.telemetry import metrics as JM
    from mmlspark_tpu_torch.core.telemetry import metrics as PM

    for name, kind in JM.DECLARED_METRICS.items():
        if name.startswith(("xla.", "device.", "dist.")):
            assert PM.DECLARED_METRICS.get(name) == kind, name
    for name in ("xla.compile.latency", "dist.rendezvous.latency"):
        assert PM.HISTOGRAM_FAMILY[name] == JM.HISTOGRAM_FAMILY[name]


def test_ci_sanitizer_matches_exposition():
    ci = _load_tool("ci")
    from mmlspark_tpu_torch.core.telemetry.exposition import sanitize_name

    for name in ("a.b.c", "a-b/c", "9lives", "x{y}", "ok_name:x",
                 "serving.request.latency"):
        assert ci._sanitize_metric_name(name) == sanitize_name(name)


# ----------------------------------------- serving debug endpoints

@pytest.fixture
def live_server():
    from mmlspark_tpu_torch.core.pipeline import LambdaTransformer
    from mmlspark_tpu_torch.io.feed import DeviceFeed
    from mmlspark_tpu_torch.serving.server import ServingServer

    feed = DeviceFeed(torch.device("cpu"))

    def fn(table):
        v = np.asarray(table["v"], np.float32)
        dv = feed.put(v)
        return table.with_column("y", dv.numpy() * 2.0)

    srv = ServingServer(LambdaTransformer(fn), reply_col="y",
                        name="obs-dev", path="/score", input_schema=["v"])
    info = srv.start()
    try:
        yield info
    finally:
        srv.stop()


def test_unknown_trace_id_clean_404(live_server):
    base = live_server.url.rsplit("/", 1)[0]
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(base + "/trace/no-such-trace-id")
    err = exc_info.value
    assert err.code == 404
    assert json.loads(err.read().decode())["error"] == "unknown trace id"


def test_metrics_content_type_and_device_signals(live_server, monkeypatch,
                                                 sentry):
    """Each scrape samples device memory first (faked here: this process
    has no card), so the gauges ride /metrics and /metrics.json."""
    fake = _FakeCuda()
    monkeypatch.setattr(device_obs, "_cuda_if_initialized", lambda: fake)
    device_obs.note_build("csrc/x.cu", 0.25)
    base = live_server.url.rsplit("/", 1)[0]
    with urllib.request.urlopen(base + "/metrics") as resp:
        ctype = resp.headers["Content-Type"]
        body = resp.read().decode("utf-8")
    assert ctype.startswith("text/plain; version=0.0.4")
    assert "device_hbm_bytes_in_use" in body
    assert "device_live_buffer_count" in body
    assert "xla_compile_count" in body
    assert "xla_compile_latency_count" in body
    calls = fake.calls
    with urllib.request.urlopen(base + "/metrics.json") as resp:
        snap = json.loads(resp.read().decode("utf-8"))
    assert fake.calls > calls
    assert snap["gauges"]["device.hbm.peak_bytes"] == 5500


def test_trace_json_live_roundtrip_nesting(live_server):
    from mmlspark_tpu_torch.io.http.clients import send_request
    from mmlspark_tpu_torch.io.http.schema import to_http_request

    telemetry.clear_spans()
    resp = send_request(to_http_request(
        live_server.url, {"v": 3.0},
        headers={"X-Trace-Id": "chromeacceptance1"}))
    assert resp.status_code == 200
    base = live_server.url.rsplit("/", 1)[0]
    with urllib.request.urlopen(base + "/trace.json") as r:
        doc = json.loads(r.read().decode("utf-8"))
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert all(e["dur"] >= 0 for e in xs)
    ours = [e for e in xs if e["args"]["trace_id"] == "chromeacceptance1"]
    assert "serving.request" in {e["name"] for e in ours}
    by_id = {e["args"]["span_id"]: e for e in ours}
    request_ev = next(e for e in ours if e["name"] == "serving.request")
    children = [e for e in ours if e["args"]["parent_id"] in by_id
                and e["args"]["span_id"] != request_ev["args"]["span_id"]]
    assert children, "request must have linked child events"
    telemetry.clear_spans()


# ------------------------------------------------------------------ hooks

def test_annotation_hook_enters_the_factory_for_matching_spans():
    seen = []

    class Rec:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            seen.append(("in", self.name))

        def __exit__(self, *exc):
            seen.append(("out", self.name))

    port_spans.set_annotation_hook(Rec, ("training.step",))
    try:
        assert port_spans.get_annotation_hook() == (Rec, ("training.step",))
        with telemetry.span("training.step"):
            with telemetry.span("other.thing"):
                pass
        with device_obs.device_annotation("training.step.inner"):
            pass
        assert isinstance(device_obs.device_annotation("nope"),
                          type(__import__("contextlib").nullcontext()))
    finally:
        port_spans.set_annotation_hook(None, ())
    assert seen == [("in", "training.step"), ("out", "training.step"),
                    ("in", "training.step.inner"),
                    ("out", "training.step.inner")]


def test_device_annotations_show_in_a_profiler_run():
    """enable_device_annotations arms torch.profiler.record_function: a
    profiled step's span names are events of the capture."""
    from torch.profiler import ProfilerActivity, profile

    assert device_obs.enable_device_annotations()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with telemetry.span("training.step"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            with telemetry.span("pipeline.assemble"):
                torch.ones(8).sum()
        names = {e.key for e in prof.key_averages()}
    finally:
        assert not device_obs.enable_device_annotations(False)
    assert {"training.step", "pipeline.assemble"} <= names
    assert port_spans.get_annotation_hook() == (None, ())


def test_lock_factory_names_the_locks_and_the_sanitizer_sees_a_graph():
    """A recording lock factory installed through set_lock_factory builds
    the flow runtime's named locks; a sanitizer installed through
    set_sanitizer sees the graph, every credit acquired and released
    (balanced), the end-of-stream markers and the clean end."""
    import threading

    from mmlspark_tpu_torch.io.pipeline import HostPipeline, PipelineStage

    made = []

    def lock(name):
        made.append(name)
        return threading.Lock()

    def rlock(name):
        made.append(name)
        return threading.RLock()

    class San:
        def __init__(self):
            self.graphs = self.acq = self.rel = self.eofs = self.ends = 0
            self.mu = threading.Lock()

        def on_graph(self, g):
            self.graphs += 1

        def on_credit_acquire(self, c):
            with self.mu:
                self.acq += 1

        def on_credit_release(self, c):
            with self.mu:
                self.rel += 1

        def on_eof(self, g, idx):
            self.eofs += 1

        def on_graph_eof(self, g):
            self.ends += 1

    assert sync.lock_factory() is None
    san = San()
    sync.set_lock_factory((lambda name: lock(name),
                           lambda name: rlock(name)))
    flow.set_sanitizer(san)
    try:
        assert sync.lock_factory() is not None
        assert sync.make_lock("test.lock") is not None
        pipe = HostPipeline([PipelineStage("double", lambda x: 2 * x,
                                           workers=2)])
        assert list(pipe.run(range(10))) == [2 * i for i in range(10)]
    finally:
        flow.set_sanitizer(None)
        sync.set_lock_factory(None)
    assert sync.lock_factory() is None
    assert "test.lock" in made
    assert {"flow.reorder", "flow.err", "flow.high_water"} <= set(made)
    assert san.graphs == 1 and san.ends == 1 and san.eofs >= 1
    assert san.acq == san.rel and san.acq >= 10


# ------------------------------------------------------ ascii renderers

def test_ascii_renderers_match_the_jax_packages():
    from mmlspark_tpu.core.telemetry import exposition as JE
    from mmlspark_tpu_torch.core.telemetry import exposition as PE

    roots = [{"name": "serving.request", "wall_s": 0.0123, "error": None,
              "attrs": {"status": 200}, "children": [
                  {"name": "serving.batcher.run", "wall_s": 0.004,
                   "attrs": {}, "children": []},
                  {"name": "feed.transfer", "wall_s": 0.001,
                   "error": "TimeoutError", "attrs": {"bytes": 64},
                   "children": []}]}]
    assert PE.format_span_tree(roots) == JE.format_span_tree(roots)
    hists = {"a.latency": {"count": 3, "p50": 0.01, "p95": 0.2, "p99": None},
             "b.bytes": {"count": 0}}
    assert PE.format_latency_table(hists) == JE.format_latency_table(hists)
    assert telemetry.format_span_tree is PE.format_span_tree


def test_obs_report_renders_the_ports_fleet_and_incident(tmp_path):
    obs_report = _load_tool("obs_report")
    from mmlspark_tpu_torch.core.telemetry.metrics import (BUCKET_FAMILIES,
                                                           Histogram)

    h = Histogram("h", BUCKET_FAMILIES["latency"])
    for v in (0.01, 0.02, 0.4):
        h.observe(v)
    wire = dict(h.snapshot())
    wire["buckets"] = [["+Inf" if le == float("inf") else le, c]
                       for le, c in wire["buckets"]]
    src = {"counters": {"serving.fleet.request": 3},
           "gauges": {"serving.fleet.healthy": 2.0},
           "histograms": {"serving.request.latency": json.loads(
               json.dumps(wire))}}
    merged = telemetry.merge_snapshots({"gateway": src, "r:1": src})
    alerts = [{"slo": "availability", "state": "firing",
               "burn_fast": 42.0, "burn_slow": 12.0}]
    text = obs_report.render_fleet_report(merged, alerts=alerts)
    assert "r:1" in text and "availability" in text and "firing" in text
    assert "serving.request.latency" in text
    rec = telemetry.FlightRecorder(str(tmp_path))
    bundle = rec.dump("slo availability", merged=merged, alerts=alerts)
    itext = obs_report.render_incident(bundle)
    assert "slo availability" in itext and "firing" in itext
