"""The port's compressed wire (mmlspark_tpu_torch.ops.wire_codec and the
compressed `DeviceFeed.put_group`) held against the JAX package's: the
encoder gives the same arrays, the plain decode is byte-equal to the
JAX decode through its Pallas kernel in interpret mode and to the host
decode, and the feed's accounting of raw and sent bytes is the JAX
feed's for the same group.  Every comparison is exact: the wire is
bytes.
"""
import functools

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.io.feed import DeviceFeed as JFeed
from mmlspark_tpu.io.feed import FeedTelemetry as JTelemetry
from mmlspark_tpu.ops import wire_codec as JW
from mmlspark_tpu_torch.core import telemetry as core_telemetry
from mmlspark_tpu_torch.io.feed import DeviceFeed, FeedTelemetry
from mmlspark_tpu_torch.ops import wire_codec as W

torch.set_num_threads(2)


def _cases():
    """The JAX package's cases (tests/test_wire_codec.py:20-31)."""
    rng = np.random.default_rng(0)
    return {
        "zeros": np.zeros((4, 32, 32, 3), np.uint8),
        "quantized": (rng.integers(0, 6, (3, 16, 16, 3)) * 40
                      ).astype(np.uint8),
        "noise": rng.integers(0, 255, (2, 17, 13)).astype(np.uint8),
        "long_runs": np.repeat(
            np.arange(5, dtype=np.uint8), 1000).reshape(10, 500),
        "float32": (rng.integers(0, 3, (64,)).astype(np.float32) * 0.5),
        "single": np.array([7], np.uint8),
    }


CASES = _cases()


@functools.lru_cache(maxsize=None)
def _jax_pallas_decode(name: str) -> np.ndarray:
    p = JW.rle_encode(CASES[name])
    raw = JW.decode_bytes(jax.device_put(p.values), jax.device_put(p.ends),
                          p.first_run, p.n_pad, use_pallas=True)
    return np.asarray(raw)


@pytest.mark.parametrize("name", list(CASES))
def test_rle_encode_gives_the_jax_arrays(name):
    arr = CASES[name]
    got, ref = W.rle_encode(arr), JW.rle_encode(arr)
    for field in ("values", "ends", "first_run"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (got.n_pad, got.nbytes_raw, got.shape, got.dtype) == \
        (ref.n_pad, ref.nbytes_raw, ref.shape, ref.dtype)
    assert got.wire_nbytes == ref.wire_nbytes
    assert W.rle_ratio(got) == JW.rle_ratio(ref)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_decode_equals_the_pallas_kernel_and_the_host(name):
    arr = CASES[name]
    p = W.rle_encode(arr)
    before = W.LAUNCHES
    raw = W.decode_bytes(torch.from_numpy(p.values), torch.from_numpy(p.ends),
                         p.n_pad)
    assert W.LAUNCHES == before  # a CPU tensor takes the plain version
    assert raw.dtype == torch.uint8 and raw.shape == (p.n_pad,)
    np.testing.assert_array_equal(raw.numpy(), _jax_pallas_decode(name))
    host = W.decode_host(p)
    assert host.dtype == arr.dtype and host.shape == arr.shape
    np.testing.assert_array_equal(host, arr)
    np.testing.assert_array_equal(
        raw.numpy()[:p.nbytes_raw].view(arr.dtype).reshape(arr.shape), arr)


def test_decode_rejects_what_it_cannot_take():
    p = W.rle_encode(CASES["quantized"])
    v, e = torch.from_numpy(p.values), torch.from_numpy(p.ends)
    with pytest.raises(TypeError):
        W.decode_bytes(v, e.to(torch.int64), p.n_pad)
    with pytest.raises(ValueError):
        W.decode_bytes(v[:-1], e, p.n_pad)
    with pytest.raises(ValueError):
        W.decode_bytes(v, e, p.n_pad + 1)


def _group():
    rng = np.random.default_rng(1)
    return [np.zeros((4, 64, 64, 3), np.uint8),
            # flat gray 8-pixel blocks, as tools/feed_bench.py makes them
            (rng.integers(0, 6, (4, 32, 4, 1)) * 40
             ).astype(np.uint8).repeat(8, axis=2).repeat(3, axis=3),
            np.repeat(np.arange(8, dtype=np.uint8), 2400).reshape(8, 2400),
            CASES["float32"]]


def test_compressed_put_group_matches_the_jax_feed():
    arrays = _group()
    jtel = JTelemetry()
    jouts = JFeed(telemetry=jtel, shard_strategy="compressed").put_group(
        [JW.rle_encode(a) for a in arrays])
    tel = FeedTelemetry()
    core_telemetry.reset_counters("io.feed.shard")
    outs = DeviceFeed(torch.device("cpu"), telemetry=tel).put_group(
        [W.rle_encode(a) for a in arrays])
    assert len(outs) == len(arrays)
    for a, o, jo in zip(arrays, outs, jouts):
        assert o.dtype == torch.from_numpy(a).dtype and tuple(o.shape) == a.shape
        np.testing.assert_array_equal(o.numpy(), a)
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    snap, jsnap = tel.snapshot(), jtel.snapshot()
    for k in ("compressed_groups", "wire_bytes_raw", "wire_bytes_sent",
              "bytes_moved", "transfer_calls", "chunks_fed"):
        assert snap[k] == jsnap[k], k
    assert snap["compressed_groups"] == 1
    assert 0 < snap["wire_bytes_sent"] < snap["wire_bytes_raw"]
    assert core_telemetry.counters("io.feed.shard") == {
        "io.feed.shard.compressed_groups": 1}


def test_a_mixed_group_raises():
    a = np.arange(20, dtype=np.uint8).reshape(4, 5)
    feed = DeviceFeed(torch.device("cpu"), telemetry=FeedTelemetry())
    with pytest.raises(TypeError, match="mixes"):
        feed.put_group([W.rle_encode(a), a])
    # the JAX feed refuses the same group
    with pytest.raises(Exception):
        JFeed(telemetry=JTelemetry()).put_group([JW.rle_encode(a), a])
