"""The port's DeviceFeed surface (mmlspark_tpu_torch/io/feed.py) held
against the JAX package's io/feed.py on the CPU: the coalescing `run`
(same seeded chunks, same compute: outputs equal exactly, the transfer
counts equal), `put_group`, `stream`, the telemetry fields and
`summarize` (equal on the same counters), the configuration surface
(`default_depth`, `load_tuned`, the strategy's precedence and
validation), the degrade rung of a packed transfer, `H2DStage` and
`host_local_feed` on a world-1 gloo mesh.  Tolerance: exact — both sides
move bytes and apply the same f32 arithmetic to them.
"""
import json
import queue

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.io import feed as JF
from mmlspark_tpu_torch.core import telemetry
from mmlspark_tpu_torch.io import feed as PF
from mmlspark_tpu_torch.io.feed import (FEED_TELEMETRY, DeviceFeed,
                                        FeedTelemetry, H2DStage,
                                        default_depth, load_tuned)
from mmlspark_tpu_torch.utils.faults import FAULTS, FaultPlan

torch.set_num_threads(2)

CPU = torch.device("cpu")
# counters that measure time, not work: they differ run to run; and the
# port's own counters of the copies timed on the card, which the JAX
# package has not
TIMED = ("transfer_s", "stall_decode_s", "stall_drain_s", "compute_s",
         "wall_s", "shard_wall_s", "shard_put_s") + FeedTelemetry._DEVICE_FIELDS


def _chunks(rng, n, shape, dtype=np.uint8):
    out = []
    for _ in range(n):
        if np.issubdtype(dtype, np.integer):
            out.append(rng.integers(0, 250, shape).astype(dtype))
        else:
            out.append(rng.standard_normal(shape).astype(dtype))
    return out


def _work(snap):
    return {k: v for k, v in snap.items() if k not in TIMED}


def _clear_tuned_cache():
    with PF._TUNED_LOCK:
        PF._TUNED_CACHE.clear()


# ---- the coalescing run against the JAX package's ---------------------------

def test_run_same_shape_chunks_coalesce_like_jax():
    rng = np.random.default_rng(0)
    chunks = [(c, c.shape[0] - (i % 2))
              for i, c in enumerate(_chunks(rng, 8, (4, 5, 5, 3)))]
    jtel, ptel = JF.FeedTelemetry(), FeedTelemetry()
    ref = JF.DeviceFeed(depth=2, coalesce=4, telemetry=jtel).run(
        iter(chunks), lambda x: jnp.asarray(x, jnp.float32).sum(axis=(1, 2))
        * 0.5, greedy=False)
    got = DeviceFeed(CPU, depth=2, coalesce=4, telemetry=ptel).run(
        iter(chunks), lambda x: x.float().sum(dim=(1, 2)) * 0.5,
        greedy=False)
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert _work(ptel.snapshot()) == _work(jtel.snapshot())
    assert ptel.snapshot()["transfer_calls"] == 2  # 8 chunks / coalesce=4
    assert ptel.snapshot()["coalesced_chunks"] == 8


def test_run_mixed_shapes_byte_pack_like_jax():
    rng = np.random.default_rng(1)
    chunks = [
        (rng.integers(0, 255, (4, 6, 6, 3)).astype(np.uint8), 4),
        (rng.integers(0, 255, (4, 8, 8, 3)).astype(np.uint8), 3),
        (rng.standard_normal((2, 5)).astype(np.float32), 2),
        (rng.integers(0, 255, (4, 6, 6, 3)).astype(np.uint8), 2),
    ]
    jtel, ptel = JF.FeedTelemetry(), FeedTelemetry()
    ref = JF.DeviceFeed(depth=2, coalesce=4, telemetry=jtel).run(
        iter(chunks), lambda x: jnp.asarray(x, jnp.float32) * 2.0 + 1.0,
        greedy=False)
    got = DeviceFeed(CPU, depth=2, coalesce=4, telemetry=ptel).run(
        iter(chunks), lambda x: x.float() * 2.0 + 1.0, greedy=False)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert _work(ptel.snapshot()) == _work(jtel.snapshot())
    assert ptel.snapshot()["transfer_calls"] == 1


@pytest.mark.parametrize("depth", [2, 4])
def test_run_keeps_every_group_under_depth(depth):
    rng = np.random.default_rng(2)
    chunks = [(c, c.shape[0]) for c in _chunks(rng, 24, (4, 16, 3))]
    feed = DeviceFeed(CPU, depth=depth, coalesce=2,
                      telemetry=FeedTelemetry())
    got = feed.run(iter(chunks), lambda x: x.to(torch.int32) + 1,
                   greedy=False)
    for g, (c, _n) in zip(got, chunks):
        np.testing.assert_array_equal(g, c.astype(np.int32) + 1)
    assert feed.telemetry.snapshot()["groups"] == 12


def test_coalesced_feed_beats_naive_on_transfer_calls():
    rng = np.random.default_rng(3)
    chunks = [(c, 16) for c in _chunks(rng, 16, (16, 8, 8, 3))]
    tel = FeedTelemetry()
    got = DeviceFeed(CPU, depth=2, coalesce=8, telemetry=tel).run(
        iter(chunks), lambda x: x.float().mean(dim=(1, 2, 3)), greedy=False)
    for g, (c, _n) in zip(got, chunks):
        np.testing.assert_allclose(g, c.astype(np.float32).mean(axis=(1, 2, 3)),
                                   rtol=1e-6)
    assert tel.snapshot()["transfer_calls"] * 4 <= len(chunks)


def test_greedy_run_pulls_ready_chunks_off_a_pipeline_source():
    """A HostPipeline's FeedSource answers `get_nowait`: a greedy run
    packs what is ready and keeps feed order."""
    from mmlspark_tpu_torch.io.pipeline import HostPipeline, PipelineStage

    pipe = HostPipeline([PipelineStage(
        "assemble", lambda i: (np.full((2, 3), i, np.int32), 2), workers=4)])
    tel = FeedTelemetry()
    got = DeviceFeed(CPU, coalesce=4, telemetry=tel).run(
        pipe.feed_source(range(40)), lambda x: x * 1)
    assert [int(g[0, 0]) for g in got] == list(range(40))
    assert tel.snapshot()["chunks_fed"] == 40
    src = HostPipeline([PipelineStage("a", lambda i: i)]).feed_source([])
    src.start()
    try:
        item = src.get_nowait()
    except queue.Empty:
        item = src.get()
    assert item is PF.FEED_END


def test_a_packed_transfer_out_of_retries_degrades_stickily():
    """The first rung: a packed transfer that exhausts its retries is
    counted and warned, goes on as single puts, and the feed stays
    unpipelined; every chunk still arrives, in order, on the device."""
    rng = np.random.default_rng(4)
    chunks = [(c, 4) for c in _chunks(rng, 6, (4, 3))]
    telemetry.reset_counters("feed.")
    gauge = telemetry.gauge("io.feed.degraded_engines").value
    feed = DeviceFeed(CPU, coalesce=3, transfer_retries=2,
                      telemetry=FeedTelemetry())
    with FAULTS.arm(FaultPlan().on("feed.device_put", nth=[0, 1])):
        with pytest.warns(RuntimeWarning, match="unpipelined"):
            got = feed.run(iter(chunks), lambda x: x * 1, greedy=False)
    assert feed.degraded
    for g, (c, _n) in zip(got, chunks):
        np.testing.assert_array_equal(g, c)
    snap = feed.telemetry.snapshot()
    assert snap["coalesced_chunks"] == 0 and snap["transfer_calls"] == 6
    assert telemetry.counters("feed.") == {"feed.transfer_retry": 1,
                                           "feed.degraded": 1}
    assert telemetry.gauge("io.feed.degraded_engines").value == gauge + 1


def test_put_group_mixed_shape_round_trip_like_jax():
    rng = np.random.default_rng(5)
    arrays = [rng.integers(0, 255, (4, 7, 3)).astype(np.uint8),
              rng.integers(-100, 100, (5,)).astype(np.int32),
              rng.standard_normal((3, 9)).astype(np.float32),
              rng.standard_normal((2, 2, 2)).astype(np.float16)]
    jtel, ptel = JF.FeedTelemetry(), FeedTelemetry()
    ref = JF.DeviceFeed(telemetry=jtel).put_group(arrays)
    got = DeviceFeed(CPU, telemetry=ptel).put_group(arrays)
    for a, g, r in zip(arrays, got, ref):
        assert g.numpy().dtype == a.dtype and tuple(g.shape) == a.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert _work(ptel.snapshot()) == _work(jtel.snapshot())


def test_put_and_put_group_counters_equal_jax():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 255, (4, 8, 8, 3)).astype(np.uint8)
    b = rng.standard_normal((10,)).astype(np.float32)
    jtel, ptel = JF.FeedTelemetry(), FeedTelemetry()
    jf, pf = JF.DeviceFeed(depth=2, telemetry=jtel), \
        DeviceFeed(CPU, depth=2, telemetry=ptel)
    jf.put(a, block=True)
    np.testing.assert_array_equal(pf.put(a, block=True).numpy(), a)
    jf.put_group([a, b])
    pf.put_group([a, b])
    assert _work(ptel.snapshot()) == _work(jtel.snapshot())
    assert ptel.snapshot()["transfer_calls"] == 2
    assert ptel.transfer_seconds() >= ptel.snapshot()["transfer_s"]


def test_stream_round_trip_in_order():
    rng = np.random.default_rng(7)
    items = [(rng.standard_normal((6, 3)).astype(np.float32),
              rng.integers(0, 9, (6,)).astype(np.int32)) for _ in range(7)]
    out = list(DeviceFeed(CPU, depth=2, telemetry=FeedTelemetry()).stream(
        iter(items)))
    assert len(out) == 7
    for (hx, hy), (dx, dy) in zip(items, out):
        np.testing.assert_array_equal(dx.numpy(), hx)
        np.testing.assert_array_equal(dy.numpy(), hy)


def test_process_telemetry_sink_is_shared():
    before = FEED_TELEMETRY.snapshot()
    DeviceFeed(CPU).put(np.zeros((2, 2), np.uint8))
    d = FEED_TELEMETRY.delta(before)
    assert d["transfer_calls"] == 1 and d["bytes_moved"] == 4


# ---- telemetry ----------------------------------------------------------

def test_telemetry_fields_are_the_jax_packages():
    assert FeedTelemetry._FIELDS == JF.FeedTelemetry._FIELDS
    assert FeedTelemetry._MAX_FIELDS == JF.FeedTelemetry._MAX_FIELDS
    assert PF.FEED_FAULT_POINTS == JF.FEED_FAULT_POINTS
    tel = FeedTelemetry()
    tel.note_max(transfer_concurrency=3)
    tel.note_max(transfer_concurrency=2)
    before = tel.snapshot()
    tel.add(transfer_s=0.5, shard_put_s=0.25)
    assert tel.transfer_seconds() == 0.75
    assert tel.delta(before)["transfer_concurrency"] == 3  # a mark, not a sum


@pytest.mark.parametrize("seed", range(4))
def test_summarize_equals_jax(seed):
    rng = np.random.default_rng(seed)
    d = {f: float(rng.integers(0, 50)) * rng.choice([0.0, 1.0, 0.37])
         for f in FeedTelemetry._FIELDS + FeedTelemetry._MAX_FIELDS}
    d["wall_s"] = float(rng.uniform(0.5, 2.0))
    got, ref = FeedTelemetry.summarize(d), JF.FeedTelemetry.summarize(d)
    # h2d_gbps is the port's copies timed on the card, not their enqueue
    assert got.pop("h2d_gbps") is None
    ref.pop("h2d_gbps")
    assert got == ref
    d.update(h2d_device_s=0.5, h2d_device_bytes=4e9)
    assert FeedTelemetry.summarize(d)["h2d_gbps"] == 8.0
    assert FeedTelemetry.summarize({}) == JF.FeedTelemetry.summarize({})


def test_telemetry_summarize_fields_of_a_run():
    rng = np.random.default_rng(8)
    tel = FeedTelemetry()
    chunks = [(c, 4) for c in _chunks(rng, 8, (4, 8, 8, 3))]
    DeviceFeed(CPU, depth=2, coalesce=4, telemetry=tel).run(
        iter(chunks), lambda x: x.float())
    s = FeedTelemetry.summarize(tel.snapshot())
    assert s["chunks_fed"] == 8 and s["h2d_path"] == "coalesced"
    assert s["feed_bytes"] >= sum(c.nbytes for c, _n in chunks)
    assert s["overlap_frac"] is not None and 0.0 <= s["overlap_frac"] <= 1.0
    assert telemetry.gauge("io.feed.stall_s").value == s["stall_s"]


def test_feed_series_are_declared_as_in_the_jax_package():
    from mmlspark_tpu.core.telemetry import metrics as JM
    from mmlspark_tpu_torch.core.telemetry import metrics as PM

    for name, kind in JM.DECLARED_METRICS.items():
        if name.startswith(("io.feed.", "feed.")) or name.endswith(".h2d"):
            assert PM.DECLARED_METRICS.get(name) == kind, name
    for name in ("io.feed.shard.latency", "io.feed.shard.bytes"):
        assert PM.buckets_for(name) == JM.buckets_for(name)


# ---- the configuration surface ------------------------------------------

def test_default_depth_env_override(monkeypatch):
    monkeypatch.delenv("MMLSPARK_FEED_DEPTH", raising=False)
    monkeypatch.delenv("MMLSPARK_FEED_TUNED", raising=False)
    assert default_depth() == 2
    monkeypatch.setenv("MMLSPARK_FEED_DEPTH", "4")
    assert default_depth() == JF.default_depth() == 4
    assert DeviceFeed(CPU).depth == 4
    monkeypatch.setenv("MMLSPARK_FEED_DEPTH", "bogus")
    assert default_depth() == 2
    assert DeviceFeed(CPU, depth=0).depth == 1


def test_tuned_config_adopted_by_default_knobs(tmp_path, monkeypatch):
    """Explicit argument > environment > tuned file > default, as in the
    JAX package; the file is read once a process."""
    cfg = tmp_path / "tuned.json"
    cfg.write_text(json.dumps({"depth": 3, "coalesce": 6,
                               "strategy": "coalesced"}))
    monkeypatch.setenv("MMLSPARK_FEED_TUNED", str(cfg))
    monkeypatch.delenv("MMLSPARK_FEED_DEPTH", raising=False)
    monkeypatch.delenv("MMLSPARK_FEED_SHARD", raising=False)
    _clear_tuned_cache()
    try:
        assert load_tuned()["depth"] == 3
        feed = DeviceFeed(CPU)
        assert (feed.depth, feed.coalesce, feed.shard_strategy) == \
            (3, 6, "coalesced")
        explicit = DeviceFeed(CPU, depth=1, coalesce=2, shard_strategy="auto")
        assert (explicit.depth, explicit.coalesce,
                explicit.shard_strategy) == (1, 2, "auto")
        cfg.write_text(json.dumps({"depth": 5}))
        assert load_tuned()["depth"] == 3  # cached: read once a process
        monkeypatch.setenv("MMLSPARK_FEED_SHARD", "sharded")
        assert DeviceFeed(CPU).shard_strategy == "sharded"  # env > file
    finally:
        _clear_tuned_cache()


def test_tuned_config_corrupt_file_is_empty_not_fatal(tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv("MMLSPARK_FEED_TUNED", str(bad))
    _clear_tuned_cache()
    try:
        assert load_tuned() == {}
        assert DeviceFeed(CPU).depth >= 1
    finally:
        _clear_tuned_cache()


def test_shard_strategy_rejects_unknown():
    for s in ("auto", "sharded", "coalesced", "compressed"):
        assert DeviceFeed(CPU, shard_strategy=s).shard_strategy == s
    with pytest.raises(ValueError, match="shard_strategy"):
        DeviceFeed(CPU, shard_strategy="turbo")


def test_the_default_feed_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFeed()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H2DStage()


# ---- the flow stage and the host-local feed -----------------------------

def test_h2d_stage_is_registered_and_moves_items_in_order():
    from mmlspark_tpu.io.feed import H2DStage as JStage
    from mmlspark_tpu_torch.core.flow import FlowGraph

    assert (H2DStage.name, H2DStage.credits) == (JStage.name, JStage.credits)
    feed = DeviceFeed(CPU, telemetry=FeedTelemetry())
    stage = feed.stage()
    assert isinstance(stage, H2DStage) and stage.feed is feed
    rng = np.random.default_rng(9)
    items = [rng.integers(0, 9, (3, 2)).astype(np.int32) for _ in range(5)]
    items.append((np.arange(3, dtype=np.int16), np.ones(2, np.float32)))
    out = list(FlowGraph([stage], queue_size=4, span_prefix="flow").run(
        list(items)))
    for want, got in zip(items[:5], out[:5]):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(out[5][0].numpy(), items[5][0])
    assert feed.telemetry.snapshot()["chunks_fed"] == 7


def test_host_local_feed_on_a_world1_gloo_group():
    from torch_world1 import world1_gloo

    from mmlspark_tpu_torch.parallel.mesh import batch_sharding

    with world1_gloo() as mesh:
        feed = PF.host_local_feed(device="cpu", telemetry=FeedTelemetry())
        assert feed.mesh is mesh and feed._dp() == 1
        assert feed.device == CPU
        a = np.arange(24, dtype=np.float32).reshape(4, 6)
        y = feed.put(a, batch_sharding(mesh, 2))
        np.testing.assert_array_equal(y.full_tensor().numpy(), a)
        # auto at one data shard: the coalesced copy, no engine
        snap = feed.telemetry.snapshot()
        assert snap["sharded_groups"] == 0 and snap["transfer_calls"] == 1
        # a run on the world-1 mesh still packs (data degree 1)
        chunks = [(a + i, 4) for i in range(4)]
        got = feed.run(iter(chunks), lambda x: x.to_local() * 2,
                       greedy=False)
        for g, (c, _n) in zip(got, chunks):
            np.testing.assert_array_equal(g, c * 2)
        assert feed.telemetry.snapshot()["coalesced_chunks"] == 4
