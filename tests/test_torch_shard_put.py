"""The port's sharded transfer engine (mmlspark_tpu_torch/io/shard_put.py)
and meshed DeviceFeed, on 2 and 4 gloo ranks (tests/torch_dist_worker.py,
scenario "feed") and in this process, held against the JAX package's
io/shard_put.py on a mesh of as many of the conftest's virtual CPU
devices: each rank's shard equals the JAX engine's addressable shard of
the same array, per dtype, byte for byte; the fallback and auto rules,
concurrent shard puts, the retry and sticky degrade rungs, staging reuse,
an H2DStage graph through the degrade and a meshed `run` equal to the
JAX `DeviceFeed.run`.  Tolerance: exact (bytes moved, and the same f32
arithmetic on them).
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mmlspark_tpu.io import feed as JF
from mmlspark_tpu.io import shard_put as JS
from mmlspark_tpu_torch.io import shard_put as SP
from mmlspark_tpu_torch.io.feed import DeviceFeed, FeedTelemetry

from torch_dist_worker import run_ranks

torch.set_num_threads(2)

WORLDS = (2, 4)
DTYPES = ("uint8", "int32", "float32", "float16")


def _inputs(k):
    rng = np.random.default_rng(10 + k)
    dtypes = {}
    for name in DTYPES:
        dt = np.dtype(name)
        if np.issubdtype(dt, np.integer):
            dtypes[name] = rng.integers(0, 200, (2 * k, 5, 3)).astype(dt)
        else:
            dtypes[name] = rng.standard_normal((2 * k, 5, 3)).astype(dt)
    u8 = lambda *s: rng.integers(0, 200, s).astype(np.uint8)  # noqa: E731
    return {
        "dtypes": dtypes, "odd": u8(13, 7), "uneven": u8(k + 1, 4),
        "tiny": u8(k, 8), "base": u8(2 * k, 64), "conc": u8(4 * k, 257),
        "three": [u8(2 * k, 17) for _ in range(3)],
        "h2d": [np.full((4 * k, 3), float(i), np.float32) for i in range(6)],
        "chunks": [(rng.integers(0, 200, (4, 6)).astype(np.uint8), 4 - i % 2)
                   for i in range(6)],
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for k in WORLDS:
        inp = _inputs(k)
        out[k] = (inp, run_ranks("feed", inp,
                                 tmp_path_factory.mktemp(f"feed{k}"),
                                 world=k))
    return out


def _jax_mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("data",))


# ---- parity with the JAX engine ----------------------------------------

@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_each_ranks_shard_is_the_jax_engines(ranks, k, dtype):
    inp, res = ranks[k]
    arr = inp["dtypes"][dtype]
    eng = JS.ShardEngine(telemetry=JF.FeedTelemetry(), min_shard_bytes=0)
    got = eng.put_sharded(arr, NamedSharding(_jax_mesh(k), P("data", None,
                                                             None)))
    shards = sorted(got.addressable_shards, key=lambda s: s.index[0].start)
    for r in range(k):
        out = res[r][("dtype", dtype)]
        want = np.asarray(shards[r].data)
        assert out["local"].dtype == want.dtype
        np.testing.assert_array_equal(out["local"], want)
        np.testing.assert_array_equal(out["full"], arr)
        assert out["shape"] == arr.shape
        assert out["no_copy"], "DTensor.from_local copied the shard"
        snap = out["snap"]
        assert (snap["sharded_groups"], snap["shard_puts"],
                snap["fallback_groups"]) == (1, 1, 0)
        assert snap["bytes_moved"] == arr.nbytes // k  # its own rows only


@pytest.mark.parametrize("k", WORLDS)
def test_replicated_uneven_and_tiny_batches(ranks, k):
    inp, res = ranks[k]
    for r in range(k):
        local, sharded = res[r]["replicated"]
        np.testing.assert_array_equal(local, inp["odd"])
        assert sharded == 1
        snap, path, degraded = res[r]["uneven"]
        assert snap is not None, "an uneven batch was planned"
        assert (snap["fallback_groups"], snap["sharded_groups"]) == (1, 0)
        assert path == "fallback" and not degraded
        full, tsnap = res[r]["tiny"]
        np.testing.assert_array_equal(full, inp["tiny"])
        assert tsnap["sharded_groups"] == 0 and tsnap["fallback_groups"] == 0
        np.testing.assert_array_equal(res[r]["strided"], inp["base"][:, ::2])


@pytest.mark.parametrize("k", WORLDS)
def test_every_ranks_shard_put_is_in_flight_at_once(ranks, k):
    inp, res = ranks[k]
    for r in range(k):
        full, conc, hw = res[r]["concurrent"]
        np.testing.assert_array_equal(full, inp["conc"])
        assert conc >= 1 and hw >= 1


# ---- the fault ladder ----------------------------------------------------

@pytest.mark.chaos
@pytest.mark.parametrize("k", WORLDS)
def test_transient_fault_retried_exhausted_degrades(ranks, k):
    inp, res = ranks[k]
    for r in range(k):
        full, degraded, retries = res[r]["transient"]
        np.testing.assert_array_equal(full, inp["conc"])
        assert not degraded and retries >= 1
        ex = res[r]["exhausted"]
        assert ex["degraded"]
        # one shard a rank x the full ladder, once: the sticky degrade
        # keeps later puts out of the engine
        assert ex["fires"] == ex["retries"] == 3
        assert len(ex["outs"]) == 3
        for want, got in zip(inp["three"], ex["outs"]):
            np.testing.assert_array_equal(got, want)
        assert ex["snap"]["sharded_groups"] == 0
        assert ex["snap"]["fallback_groups"] == 1
        assert ex["counter"] == 1
        assert any("degraded to coalesced" in w for w in ex["warned"])
        raised, n, after = res[r]["engine"]
        assert raised == "ShardTransferError"
        assert after == n  # every staged buffer came back: reuse only


@pytest.mark.chaos
@pytest.mark.parametrize("k", WORLDS)
def test_h2d_stage_delivers_every_item_through_the_degrade(ranks, k):
    inp, res = ranks[k]
    for r in range(k):
        h = res[r]["h2d"]
        assert len(h["outs"]) == len(inp["h2d"])
        for want, got in zip(inp["h2d"], h["outs"]):
            np.testing.assert_array_equal(got, want)
        assert h["degraded"] and not h["feed_degraded"]
        assert h["fires"]["feed.shard_put"] == 3
        assert h["fires"]["feed.device_put"] == 1
        shed = res[r]["shed"]
        assert shed[1] == "expired"
        np.testing.assert_array_equal(shed[0], inp["h2d"][0])
        np.testing.assert_array_equal(shed[2], inp["h2d"][2])


@pytest.mark.parametrize("k", WORLDS)
def test_meshed_run_equals_the_jax_feed(ranks, k):
    inp, res = ranks[k]
    import jax.numpy as jnp

    ref = JF.DeviceFeed(mesh=_jax_mesh(k), coalesce=4).run(
        iter(inp["chunks"]), lambda x: jnp.asarray(x, jnp.float32) * 2.0
        + 1.0)
    for r in range(k):
        got, snap = res[r]["run"]
        assert len(got) == len(ref)
        for g, w in zip(got, ref):
            np.testing.assert_array_equal(g, np.asarray(w))
        # a data degree above 1 never packs; each rank moved its rows
        assert snap["coalesced_chunks"] == 0
        assert snap["bytes_moved"] == sum(c.nbytes for c, _n in
                                          inp["chunks"]) // k


# ---- in this process ------------------------------------------------------

def test_staging_buckets_reuse_not_reallocate():
    b = SP.StagingBuckets()
    sb1 = b.acquire(100_000)
    assert len(sb1.buf) >= 100_000 and len(sb1.buf) == 1 << 17
    b.release(sb1)
    sb2 = b.acquire(70_000)  # the same power-of-two bucket
    assert sb2 is sb1 and b.allocated() == 1
    b.release(sb2)
    assert b.acquire(10).buf.nbytes == 1 << 16  # the 64 KiB floor


def test_staging_bucket_fence_waits_before_reuse():
    class Fence:
        waited = 0

        def synchronize(self):
            Fence.waited += 1

    b = SP.StagingBuckets()
    sb = b.acquire(1 << 16)
    b.release(sb, fence=Fence())
    again = b.acquire(1 << 16)
    assert again is sb and again.fence is None and Fence.waited == 1


def test_staging_buckets_are_bounded():
    b = SP.StagingBuckets(max_per_bucket=2)
    bufs = [b.acquire(1 << 16) for _ in range(4)]
    for sb in bufs:
        b.release(sb)
    assert b.allocated() == 2


def test_a_cpu_put_discards_its_staging_buffer():
    """`torch.from_numpy` aliases the bucket for the life of the tensor:
    the buffer must not come back to a free list."""
    from torch_world1 import world1_gloo

    from mmlspark_tpu_torch.parallel.mesh import batch_sharding

    staging = SP.StagingBuckets()
    eng = SP.ShardEngine(telemetry=FeedTelemetry(), staging=staging,
                         min_shard_bytes=0)
    with world1_gloo() as mesh:
        base = np.arange(8 * 64, dtype=np.uint8).reshape(8, 64)
        y = eng.put_sharded(base[:, ::2], batch_sharding(mesh, 2))
        assert staging.allocated() == 0
        want = base[:, ::2].copy()
        staging.acquire(want.nbytes).buf[:] = 0  # a new buffer, not y's
        np.testing.assert_array_equal(y.to_local().numpy(), want)


def test_world1_sharded_strategy_takes_the_engine_and_auto_does_not():
    """On one data shard `auto` stays coalesced, as the JAX package does
    on one device; `sharded` is a directive and takes the engine."""
    from torch_world1 import world1_gloo

    from mmlspark_tpu_torch.parallel.mesh import batch_sharding

    a = np.arange(4 * 1024, dtype=np.float32).reshape(4, 1024)
    with world1_gloo() as mesh:
        for strategy, groups in (("auto", 0), ("sharded", 1),
                                 ("coalesced", 0)):
            tel = FeedTelemetry()
            y = DeviceFeed(mesh=mesh, telemetry=tel,
                           shard_strategy=strategy).put(
                a, batch_sharding(mesh, 2), block=True)
            np.testing.assert_array_equal(y.full_tensor().numpy(), a)
            assert tel.snapshot()["sharded_groups"] == groups, strategy
        eng = SP.ShardEngine(telemetry=FeedTelemetry())
        assert eng.plan(a[:, :8], batch_sharding(mesh, 2)) is None  # floor
        y = eng.put_sharded(a, batch_sharding(mesh, 2))
        np.testing.assert_array_equal(y.to_local().numpy(), a)
        with pytest.raises(SP.ShardTransferError, match="evenly"):
            eng.put_sharded(a[:, :8], batch_sharding(mesh, 2))
