"""The port's host library (mmlspark_tpu_torch.native: `murmur3_batch`,
`histogram`, `load_csv_numeric`, built with g++ from native/src/host.cpp)
held against the JAX package's native module and against its own plain
versions; `io.binary.read_csv`, `io.parquet` and `plot/` against the JAX
package's.

All exact: hashes and parsed values equal bit for bit, histograms equal
(f64 sums of the same f32 values in the same row order), NaN equal to
NaN.  Where the JAX package's library would not build it goes quietly to
Python or np.loadtxt; the port's raises `HostLibraryError` with the
compiler's output instead (checked by pointing the build at a compiler
that fails).
"""
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu import native as JN
from mmlspark_tpu import plot as JP
from mmlspark_tpu.io import binary as JBin
from mmlspark_tpu.io import parquet as JPq
from mmlspark_tpu.online.hashing import murmurhash3_32 as j_murmur

from mmlspark_tpu_torch import Table as PTable
from mmlspark_tpu_torch import native as PN
from mmlspark_tpu_torch import plot as PP
from mmlspark_tpu_torch.io import binary as PBin
from mmlspark_tpu_torch.io import parquet as PPq
from mmlspark_tpu_torch.online.hashing import murmurhash3_32 as p_murmur

from torch_tables import assert_same_table

torch.set_num_threads(2)


def strings(n, seed):
    rng = np.random.default_rng(seed)
    out = ["", "a", "ab", "abc", "abcd", "naïve", "日本語", "x" * 1000]
    for _ in range(n):
        k = int(rng.integers(0, 40))
        out.append(bytes(rng.integers(0, 256, k, dtype=np.uint8)) if
                   rng.random() < 0.3 else "".join(
                       rng.choice(list("abcdefgh _-0123456789é"), k)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 0x9747B28C, 2 ** 32 - 1, -1])
def test_murmur3_batch_equals_the_jax_package_and_the_python_hash(seed):
    s = strings(300, abs(seed) % 1000)
    got = PN.murmur3_batch(s, seed)
    assert got.dtype == np.uint32 and got.shape == (len(s),)
    np.testing.assert_array_equal(got, JN.murmur3_batch(s, seed))
    np.testing.assert_array_equal(got, PN.murmur3_batch_plain(s, seed))
    blobs = [x.encode() if isinstance(x, str) else x for x in s]
    want = [p_murmur(b, seed & 0xFFFFFFFF) for b in blobs]
    assert got.tolist() == want
    assert want == [j_murmur(b, seed & 0xFFFFFFFF) for b in blobs]


def test_murmur3_batch_of_nothing():
    assert PN.murmur3_batch([]).shape == (0,)
    np.testing.assert_array_equal(PN.murmur3_batch([""] * 3, 1),
                                  np.full(3, 0x514E28B7, np.uint32))


@pytest.mark.parametrize("n,f,nodes,bins", [(500, 4, 3, 256), (64, 1, 1, 16),
                                            (2000, 13, 5, 64), (0, 3, 2, 8)])
def test_histogram_equals_its_plain_version_and_the_jax_package(n, f, nodes,
                                                                bins):
    rng = np.random.default_rng(n + f)
    b = rng.integers(0, bins, (n, f)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.1, 1.0, n).astype(np.float32)
    node = rng.integers(-1, nodes + 1, n).astype(np.int32)  # -1, out of range
    got = PN.histogram(b, g, h, node, nodes, bins)
    assert got.dtype == np.float64 and got.shape == (nodes, f, bins, 2)
    np.testing.assert_array_equal(got, PN.histogram_plain(b, g, h, node,
                                                          nodes, bins))
    np.testing.assert_array_equal(got, JN.histogram(b, g, h, node, nodes,
                                                    bins))


def test_histogram_casts_its_inputs_as_the_jax_package_does():
    rng = np.random.default_rng(9)
    b = rng.integers(0, 8, (50, 2))  # int64: cast to uint8
    g, h = rng.normal(size=50), np.ones(50)  # f64: cast to f32
    node = np.zeros(50, np.int64)
    np.testing.assert_array_equal(PN.histogram(b, g, h, node, 1, 8),
                                  JN.histogram(b, g, h, node, 1, 8))


def write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


CSV_CASES = {
    "header": ("a,b,c\n1,2.5,-3e2\n4,nan,6\n", True),
    "no-header": ("1,2\n3,4\n5,6", False),
    "blank-lines": ("x,y\n1,2\n\n3,4\n\n", True),
    "one-column": ("v\n1.5\n-2\ninf\n", True),
    "wide": (",".join(f"c{i}" for i in range(300)) + "\n" +
             ",".join(str(i / 7) for i in range(300)) + "\n", True),
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_load_csv_numeric_equals_the_jax_package(case, tmp_path):
    text, header = CSV_CASES[case]
    path = write(tmp_path / "t.csv", text)
    got = PN.load_csv_numeric(path, has_header=header)
    assert got.dtype == np.float64 and got.ndim == 2
    np.testing.assert_array_equal(got, JN.load_csv_numeric(
        path, has_header=header))
    if case != "blank-lines":  # np.loadtxt skips blank lines too
        np.testing.assert_array_equal(got, PN.load_csv_numeric_plain(
            path, has_header=header))
    assert_same_table(JBin.read_csv(path, has_header=header),
                      PBin.read_csv(path, has_header=header))


def test_load_csv_numeric_round_trips_f64_exactly(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 5)) * 10.0 ** rng.integers(-30, 30, (200, 5))
    x[::7, 1] = np.nan
    path = str(tmp_path / "x.csv")
    np.savetxt(path, x, delimiter=",", header="a,b,c,d,e", comments="",
               fmt="%.17g")
    np.testing.assert_array_equal(PN.load_csv_numeric(path), x)
    t = PBin.read_csv(path)
    assert t.column_names == list("abcde")
    np.testing.assert_array_equal(t["b"], x[:, 1])


@pytest.mark.parametrize("text,error,match", [
    (None, FileNotFoundError, "nope.csv"),
    ("a,b\n1,2\n3\n", ValueError, "ragged"),
    ("a,b\n1,x\n", ValueError, "non-numeric"),
    ("a,b\n1,2\n3,4,5\n", ValueError, "ragged")])
def test_bad_files_raise_as_in_the_jax_package(text, error, match, tmp_path):
    path = str(tmp_path / "nope.csv") if text is None else \
        write(tmp_path / "bad.csv", text)
    for load in (PN.load_csv_numeric, JN.load_csv_numeric, PBin.read_csv,
                 JBin.read_csv):
        with pytest.raises(error, match=match):
            load(path)


def test_read_csv_names_and_counts(tmp_path):
    path = write(tmp_path / "n.csv", "1,2\n3,4\n")
    for mod in (JBin, PBin):
        t = mod.read_csv(path, has_header=False)
        assert t.column_names == ["c0", "c1"]
        t = mod.read_csv(path, has_header=False, column_names=["p", "q"])
        assert t.column_names == ["p", "q"]
        with pytest.raises(ValueError, match="3 names for 2 columns"):
            mod.read_csv(path, has_header=False, column_names=["a", "b", "c"])


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch,
                                                         tmp_path):
    """No quiet fallback: a compiler that fails leaves every entry raising
    HostLibraryError with its output, at each call."""
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'host.cpp:1: error: broken' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(PN, "_HOST", {})
    monkeypatch.setattr(PN, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(PN.shutil, "which", lambda name: str(fake))
    path = write(tmp_path / "ok.csv", "a\n1\n")
    for call in (lambda: PN.murmur3_batch(["a"]),
                 lambda: PN.histogram(np.zeros((1, 1), np.uint8), [0.0],
                                      [1.0], [0], 1, 2),
                 lambda: PN.load_csv_numeric(path),
                 lambda: PBin.read_csv(path), PN.host_library):
        with pytest.raises(PN.HostLibraryError, match="error: broken"):
            call()


def test_no_compiler_raises(monkeypatch):
    monkeypatch.setattr(PN, "_HOST", {})
    monkeypatch.setattr(PN.shutil, "which", lambda name: None)
    with pytest.raises(PN.HostLibraryError, match="no C\\+\\+ compiler"):
        PN.murmur3_batch(["a"])


def test_the_host_library_is_apart_from_the_jpeg_decoder():
    """Its own source, no jpeglib.h, and its own hashed name under
    native/build/."""
    PN.host_library()
    with open(os.path.join(PN._DIR, "src", "host.cpp")) as f:
        src = f.read()
    assert "#include <jpeglib" not in src and "murmur3_batch" in src
    built = [n for n in os.listdir(PN.BUILD_DIR)
             if n.startswith("libmmk_host-") and n.endswith(".so")]
    assert built


# ---- parquet ----------------------------------------------------------------

def parquet_cols():
    rng = np.random.default_rng(4)
    blobs = np.empty(4, object)
    lists = np.empty(4, object)
    for i in range(4):
        blobs[i] = bytes([i, 255 - i])
        lists[i] = rng.normal(size=i + 1)
    return {"f": rng.normal(size=4), "i": np.arange(4, dtype=np.int32),
            "s": np.asarray(["a", "bb", "", "é"], object), "b": blobs,
            "l": lists, "m": rng.normal(size=(4, 3)).astype(np.float32),
            "flag": np.array([True, False, True, True])}


def test_parquet_round_trip_equals_the_jax_package(tmp_path):
    pytest.importorskip("pyarrow")
    from mmlspark_tpu import Table as JTable

    pp, jp = str(tmp_path / "p.parquet"), str(tmp_path / "j.parquet")
    PPq.write_parquet(PTable(parquet_cols()), pp)
    JPq.write_parquet(JTable(parquet_cols()), jp)
    # each package reads the other's file as its own
    for path in (pp, jp):
        assert_same_table(JPq.read_parquet(path), PPq.read_parquet(path))
    got = PPq.read_parquet(pp)
    np.testing.assert_array_equal(got["f"], parquet_cols()["f"])
    assert got["b"][1] == bytes([1, 254])
    np.testing.assert_array_equal(np.stack(got["m"]), parquet_cols()["m"])
    assert PPq.read_parquet(pp, columns=["s", "i"]).column_names == ["s", "i"]


# ---- plot -------------------------------------------------------------------

@pytest.mark.parametrize("labels", [
    (np.array([0, 1, 1, 2, 2, 2]), np.array([0, 2, 1, 2, 0, 2])),
    (np.asarray(list("abcab")), np.asarray(list("abbcb"))),
    (np.array([-1.0, 1.0, 1.0]), np.array([1.0, 1.0, -1.0]))])
def test_confusion_matrix_data_equals_the_jax_package(labels):
    cm, classes = PP.confusion_matrix_data(*labels)
    jcm, jclasses = JP.confusion_matrix_data(*labels)
    assert cm.dtype == np.int64
    np.testing.assert_array_equal(cm, jcm)
    np.testing.assert_array_equal(classes, jclasses)
    assert cm.sum() == len(labels[0])


def test_plot_helpers_return_their_arrays(monkeypatch):
    """Without matplotlib both helpers return the arrays and no axes, as
    the JAX package's do; `plot_feature_importances`' order is the JAX
    package's."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    imp = np.array([0.1, 3.0, 0.0, 2.5, 3.0, 0.7])
    for k in (20, 3):
        order, ax = PP.plot_feature_importances(imp, top_k=k)
        jorder, _ = JP.plot_feature_importances(imp, top_k=k)
        np.testing.assert_array_equal(order, jorder)
        assert ax is None
    cm, classes, ax = PP.plot_confusion_matrix([0, 1, 1], [0, 1, 0],
                                               normalize=True)
    assert ax is None and cm.tolist() == [[1, 0], [1, 1]]
