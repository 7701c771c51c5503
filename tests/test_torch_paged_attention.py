"""The port's paged decode attention (mmlspark_tpu_torch.ops.paged_attention:
the plain versions of kernels B7 and B8, which the CPU runs) held against
the JAX package's Pallas kernels `_paged_pallas` / `_paged_pallas_int8`
in interpret mode and against its gather compositions `_xla_paged` /
`_xla_paged_int8`, on the same numpy inputs; and `quantize_kv_row`,
which must give the JAX function's bits.

The setup is test_paged_attention.py's at D = 64: garbage in every pool
row (the trash page 0 included), mid-page positions, a slot at pos 0,
a slot whose table is full, and bf16 pools.  Tolerance 1e-5 abs and rel,
the JAX suite's own for kernel against gather: both sides compute in f32
from the same stored values, summed in another order.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.ops import paged_attention as JP
from mmlspark_tpu.ops.quant import quantize_kv_row as j_quantize
from mmlspark_tpu_torch.ops import paged_attention as PA
from mmlspark_tpu_torch.ops.quant import quantize_kv_row

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, D, NP, PAGE, MP = 3, 4, 64, 9, 8, 4
# slot 0: 2 live pages, mid-page pos; slot 1: 1 page; slot 2: all MP
TABLE = np.array([[1, 2, 0, 0], [3, 0, 0, 0], [4, 5, 6, 7]], np.int32)
POSITIONS = {"mid_page": [11, 3, PAGE * MP - 1], "pos0": [0, 0, 0]}


def _inputs(seed, hkv=H, dtype="float32"):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(NP, PAGE, hkv, D)).astype(np.float32)
    v = rng.normal(size=(NP, PAGE, hkv, D)).astype(np.float32)
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
                   for x in (q, k, v))
    return q, k, v


def _torch(x, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _jax(x, dtype="float32"):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


@functools.lru_cache(maxsize=None)
def _jax_b7(which, positions, dtype, seed):
    q, k, v = _inputs(seed, dtype=dtype)
    fn = JP._paged_pallas if which == "pallas" else JP._xla_paged
    return np.asarray(fn(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                         jnp.asarray(TABLE),
                         jnp.asarray(POSITIONS[positions], jnp.int32)))


@pytest.mark.parametrize("which", ["pallas", "xla"])
@pytest.mark.parametrize("positions,dtype,seed", [
    ("mid_page", "float32", 0), ("pos0", "float32", 2),
    ("mid_page", "bfloat16", 1)])
def test_b7_plain_matches_jax(which, positions, dtype, seed):
    q, k, v = _inputs(seed, dtype=dtype)
    got = PA.paged_decode_attention(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.from_numpy(TABLE),
        torch.tensor(POSITIONS[positions], dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(),
                               _jax_b7(which, positions, dtype, seed), **TOL)
    if positions == "pos0":
        # one visible position: the output is that position's v row
        for b in range(B):
            np.testing.assert_allclose(got[b].numpy(), v[TABLE[b, 0], 0],
                                       **TOL)


# B7's split-and-merge arithmetic (the CUDA kernels' rule), in PyTorch:
# per-chunk (m, l, acc), merged in chunk order with empty chunks skipped.
# At PAGE 8 the kernels' chunk is all 4 pages; 1 page a chunk leaves
# slot 1 (pos 3) and every slot at pos 0 with three empty chunks, 3 pages
# a chunk a ragged last one.  B7's limit on the card, 1e-4.
SPLIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pages_per_split", [None, 1, 3])
@pytest.mark.parametrize("positions,dtype,seed", [
    ("mid_page", "float32", 0), ("pos0", "float32", 2),
    ("mid_page", "bfloat16", 1)])
def test_b7_split_merge_matches_jax_pallas_and_plain(pages_per_split,
                                                     positions, dtype, seed):
    q, k, v = _inputs(seed, dtype=dtype)
    args = (_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
            torch.from_numpy(TABLE),
            torch.tensor(POSITIONS[positions], dtype=torch.int32))
    got = PA.paged_decode_attention_split_plain(
        *args, pages_per_split=pages_per_split)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(),
                               _jax_b7("pallas", positions, dtype, seed),
                               **SPLIT_TOL)
    np.testing.assert_allclose(
        got.numpy(), PA.paged_decode_attention_plain(*args).numpy(),
        **SPLIT_TOL)


def test_b7_split_merge_gqa_matches_jax_gather():
    q, k, v = _inputs(3, hkv=2)
    pos = np.array([9, 0, 30], np.int32)
    ref = np.asarray(JP._xla_paged(*map(jnp.asarray, (q, k, v, TABLE, pos))))
    got = PA.paged_decode_attention_split_plain(
        *map(_torch, (q, k, v)), torch.from_numpy(TABLE),
        torch.from_numpy(pos), pages_per_split=1)
    np.testing.assert_allclose(got.numpy(), ref, **SPLIT_TOL)


@pytest.mark.parametrize("page,pages", [(64, 1), (16, 4), (8, 8), (48, 1),
                                        (128, 1), (1, 64)])
def test_b7_chunks_are_whole_pages_of_about_64_rows(page, pages):
    assert PA.split_pages(page) == pages
    assert PA.split_pages(page, torch.bfloat16) == pages
    assert PA.split_pages(page, torch.float32) == pages


@pytest.mark.parametrize("page,pages", [(64, 2), (16, 8), (8, 16), (48, 2),
                                        (128, 1), (256, 1), (1, 128)])
def test_b8_chunks_are_whole_pages_of_about_128_rows(page, pages):
    """int8 rows are half a bf16 row's bytes: B8's chunk is twice B7's
    rows (the faster of the two on the H100)."""
    assert PA.split_pages(page, torch.int8) == pages


def test_b7_plain_gqa_matches_jax_gather():
    """A GQA pool (Hkv = 2 < H = 4): query head h reads pool head
    h // 2 (`jnp.repeat`), against the JAX gather, which serves GQA."""
    q, k, v = _inputs(3, hkv=2)
    pos = np.array([9, 14, 30], np.int32)
    ref = np.asarray(JP._xla_paged(*map(jnp.asarray, (q, k, v, TABLE, pos))))
    got = PA.paged_decode_attention(*map(_torch, (q, k, v)),
                                    torch.from_numpy(TABLE),
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # and it is not the tiled expansion
    tiled = PA.paged_decode_attention(
        _torch(q), *(_torch(np.tile(x, (1, 1, 2, 1))) for x in (k, v)),
        torch.from_numpy(TABLE), torch.from_numpy(pos))
    assert not np.allclose(tiled.numpy(), ref, **TOL)


@functools.lru_cache(maxsize=None)
def _int8_case(seed, hkv=H):
    q, k, v = _inputs(seed, hkv=hkv)
    kq, ks = j_quantize(jnp.asarray(k))
    vq, vs = j_quantize(jnp.asarray(v))
    return q, tuple(np.asarray(x) for x in (kq, ks, vq, vs))


@pytest.mark.parametrize("which", ["pallas", "xla"])
def test_b8_plain_matches_jax(which):
    q, pools = _int8_case(4)
    pos = np.array([13, 20, 31], np.int32)
    fn = JP._paged_pallas_int8 if which == "pallas" else JP._xla_paged_int8
    ref = np.asarray(fn(jnp.asarray(q), *map(jnp.asarray, pools),
                        jnp.asarray(TABLE), jnp.asarray(pos)))
    got = PA.paged_decode_attention_int8(
        _torch(q), *map(_torch_any, pools), torch.from_numpy(TABLE),
        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_b8_plain_gqa_matches_jax_gather():
    q, pools = _int8_case(5, hkv=1)
    pos = np.array([7, 0, 31], np.int32)
    ref = np.asarray(JP._xla_paged_int8(
        jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(TABLE),
        jnp.asarray(pos)))
    got = PA.paged_decode_attention_int8(
        _torch(q), *map(_torch_any, pools), torch.from_numpy(TABLE),
        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _torch_any(x):
    return torch.from_numpy(np.array(x))


# B8's split-and-merge arithmetic (the CUDA kernels' rule over int8
# pools: the K scale on each row's score, the V scale on its p in the V
# sum but not in l), held against the JAX kernel in interpret mode and
# its gather at TOL.  PAGE 8, MP 4: the default chunk (128 rows) is the
# whole table;
# one page a chunk leaves slot 1 (pos 7) with three empty chunks and
# every slot at pos 0 with three, three pages a chunk a ragged last one
# (empty below pos 24); pos 8 is a page's first row.
INT8_POSITIONS = {"boundary": [8, 7, PAGE * MP - 1], "pos0": [0, 0, 0],
                  "mid_page": [13, 20, 30]}


@functools.lru_cache(maxsize=None)
def _jax_b8(which, positions, seed, hkv=H):
    q, pools = _int8_case(seed, hkv)
    fn = JP._paged_pallas_int8 if which == "pallas" else JP._xla_paged_int8
    return np.asarray(fn(jnp.asarray(q), *map(jnp.asarray, pools),
                         jnp.asarray(TABLE),
                         jnp.asarray(INT8_POSITIONS[positions], jnp.int32)))


@pytest.mark.parametrize("which", ["pallas", "xla"])
@pytest.mark.parametrize("pages_per_split", [None, 1, 3])
@pytest.mark.parametrize("positions,seed", [("boundary", 4), ("pos0", 6),
                                            ("mid_page", 7)])
def test_b8_split_merge_matches_jax(which, pages_per_split, positions, seed):
    q, pools = _int8_case(seed)
    got = PA.paged_decode_attention_int8_split_plain(
        _torch(q), *map(_torch_any, pools), torch.from_numpy(TABLE),
        torch.tensor(INT8_POSITIONS[positions], dtype=torch.int32),
        pages_per_split=pages_per_split)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), _jax_b8(which, positions, seed),
                               **TOL)


@pytest.mark.parametrize("hkv,pages_per_split", [(2, 1), (1, 3), (2, None)])
def test_b8_split_merge_gqa_matches_jax_gather(hkv, pages_per_split):
    """GQA pools (the JAX kernel takes MHA pools only, so its gather is
    the reference): query head h reads pool head h // (H / Hkv)."""
    got = PA.paged_decode_attention_int8_split_plain(
        _torch(_int8_case(8, hkv)[0]), *map(_torch_any, _int8_case(8, hkv)[1]),
        torch.from_numpy(TABLE),
        torch.tensor(INT8_POSITIONS["boundary"], dtype=torch.int32),
        pages_per_split=pages_per_split)
    np.testing.assert_allclose(got.numpy(),
                               _jax_b8("xla", "boundary", 8, hkv), **TOL)


def test_b8_split_merge_scales_the_v_sum_but_not_l():
    """Doubling every V scale doubles the output: the scale rides p into
    the V sum, not into the normaliser l."""
    q, (kq, ks, vq, vs) = _int8_case(9)
    args = [_torch(q), *map(_torch_any, (kq, ks, vq, vs)),
            torch.from_numpy(TABLE),
            torch.tensor(INT8_POSITIONS["mid_page"], dtype=torch.int32)]
    base = PA.paged_decode_attention_int8_split_plain(*args, pages_per_split=1)
    args[4] = args[4] * 2
    np.testing.assert_allclose(
        PA.paged_decode_attention_int8_split_plain(*args, pages_per_split=1
                                                   ).numpy(),
        2 * base.numpy(), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_row_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(5, 7, 3, 64)) * rng.uniform(0.01, 30, (5, 7, 3, 1))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                     # an all-zero row: the 1e-8 floor
    x[1, 2, 1, :4] = [0.5, -0.5, 1.5, 127.0]   # ties round half to even
    jq, js = j_quantize(_jax(x, dtype))
    pq, ps = quantize_kv_row(_torch(x, dtype))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_wrappers_raise_on_what_they_do_not_take():
    q, k, v = (_torch(x) for x in _inputs(0))
    table, pos = torch.from_numpy(TABLE), torch.tensor([1, 2, 3])
    with pytest.raises(ValueError):                    # pool head dim
        PA.paged_decode_attention(q, k[..., :32], v[..., :32], table, pos)
    with pytest.raises(ValueError):                    # K and V differ
        PA.paged_decode_attention(q, k, v[:, :4], table, pos)
    with pytest.raises(ValueError):                    # 3 pool heads, 4 q
        PA.paged_decode_attention(q, k[:, :, :3], v[:, :, :3], table, pos)
    with pytest.raises(ValueError):                    # table rows != B
        PA.paged_decode_attention(q, k, v, table[:2], pos)
    with pytest.raises(ValueError):                    # pos shape
        PA.paged_decode_attention(q, k, v, table, pos[:2])
    with pytest.raises(ValueError):                    # scales shape
        PA.paged_decode_attention_int8(q, k, k[..., 0, 0], v, v[..., 0],
                                       table, pos)
    with pytest.raises(ValueError):                    # not CPU, not CUDA
        PA.paged_decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                  table.to("meta"), pos.to("meta"))


def test_kernel_input_checks():
    """What the CUDA wrappers refuse before a launch (checked here on CPU
    tensors; on the card the same check runs before the kernel)."""
    q, k, v = (_torch(x) for x in _inputs(0))
    table = torch.from_numpy(TABLE)
    pos = torch.tensor([1, 2, 3], dtype=torch.int32)

    def check(q, pools, scales=(), table=table, pos=pos,
              dtypes=(torch.float32,)):
        PA._check_kernel_input("t", q, pools, scales, table, pos, dtypes)

    check(q, (k, v))                                   # accepted
    scales = (k[..., 0].contiguous(), v[..., 0].contiguous())
    check(q.bfloat16(), (k.to(torch.int8), v.to(torch.int8)), scales,
          dtypes=(torch.int8,))
    with pytest.raises(TypeError):
        check(q.to(torch.int32), (k, v))               # int32 q
    with pytest.raises(TypeError):
        check(q, (k.bfloat16(), v.bfloat16()))         # pools != q type
    wide = torch.zeros(B, H, 264)
    with pytest.raises(ValueError):
        check(wide, (torch.zeros(2, 8, H, 264),) * 2)  # D > 256
    with pytest.raises(ValueError):                    # bf16 D % 8
        check(q[..., :60].bfloat16(), (k[..., :60].bfloat16(),) * 2,
              dtypes=(torch.bfloat16,))
    with pytest.raises(ValueError):                    # int8 D % 4
        check(q[..., :62], (k[..., :62].to(torch.int8),) * 2, scales,
              dtypes=(torch.int8,))
    with pytest.raises(ValueError):                    # strided q head dim
        check(torch.zeros(B, H, 2 * D)[..., ::2], (k, v))
    with pytest.raises(ValueError):                    # strided pools
        check(q, (k.transpose(0, 1), v))
    with pytest.raises(TypeError):                     # int64 table
        check(q, (k, v), table=table.long())
    with pytest.raises(TypeError):                     # f64 scales
        check(q, (k.to(torch.int8), v.to(torch.int8)),
              (scales[0].double(), scales[1]), dtypes=(torch.int8,))


def test_kernel_input_checks_take_int8_pools_at_a_word_multiple():
    """B8's split kernel loads q one value at a time and int8 rows in
    4-byte words: a bf16 q over int8 pools needs D % 4 only, where bf16
    pools need D % 8."""
    q, k, v = (_torch(x) for x in _inputs(0))
    table = torch.from_numpy(TABLE)
    pos = torch.tensor([1, 2, 3], dtype=torch.int32)
    scales = (k[..., 0].contiguous(), v[..., 0].contiguous())
    int8_pools = (k[..., :36].contiguous().to(torch.int8),
                  v[..., :36].contiguous().to(torch.int8))
    PA._check_kernel_input("t", q[..., :36].bfloat16(), int8_pools, scales,
                           table, pos, (torch.int8,))
    with pytest.raises(ValueError):
        PA._check_kernel_input("t", q[..., :36].bfloat16(),
                               tuple(p.bfloat16() for p in int8_pools), (),
                               table, pos, (torch.bfloat16,))
