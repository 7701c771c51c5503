"""Equality of a JAX-package Table and a port Table, for the parity tests
of the classic-ML slice (tests/test_torch_stages.py,
test_torch_featurize.py, test_torch_linear.py, test_torch_host_native.py).

`assert_same_table(j, p)`: the same column names in the same order, the
same row count, each dense column of the same dtype and shape with equal
values (NaN equal to NaN), each object column's values of the same types
and equal element by element (lists, arrays, strings, None, numbers), and
the same metadata (a CategoricalMap by its levels and ordinal flag).
`atol` loosens the float comparison where f32 and f64 meet; 0 asks for
equality.
"""
import numpy as np


def _same_value(a, b, atol, where):
    if a is None or b is None:
        assert a is None and b is None, f"{where}: {a!r} != {b!r}"
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert type(a) is type(b), f"{where}: {type(a)} != {type(b)}"
        assert a.dtype == b.dtype and a.shape == b.shape, \
            f"{where}: {a.dtype}{a.shape} != {b.dtype}{b.shape}"
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                _same_value(x, y, atol, f"{where}[{i}]")
        else:
            _same_array(a, b, atol, where)
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), \
            f"{where}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, atol, f"{where}[{i}]")
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), \
            f"{where}: {a!r} != {b!r}"
        for k in a:
            _same_value(a[k], b[k], atol, f"{where}[{k!r}]")
        return
    assert type(a) is type(b), f"{where}: {type(a)} != {type(b)}"
    if isinstance(a, (float, np.floating)) and np.isnan(a):
        assert np.isnan(b), f"{where}: {a!r} != {b!r}"
    elif isinstance(a, (float, np.floating)) and atol:
        assert abs(a - b) <= atol, f"{where}: {a!r} != {b!r}"
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _same_array(a, b, atol, where):
    if atol and a.dtype.kind in "fc":
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=where)
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)


def _same_meta(a: dict, b: dict, where):
    assert sorted(a) == sorted(b), f"{where}: meta {a} != {b}"
    for k in a:
        x, y = a[k], b[k]
        if hasattr(x, "levels"):
            assert list(x.levels) == list(y.levels) and \
                x.ordinal == y.ordinal, f"{where}: {k} {x.levels} != {y.levels}"
        else:
            _same_value(x, y, 0, f"{where} meta {k}")


def assert_same_table(j, p, atol: float = 0.0):
    """The JAX package's Table `j` and the port's Table `p` hold the same
    columns, values and metadata."""
    assert j.column_names == p.column_names, (j.column_names, p.column_names)
    assert j.num_rows == p.num_rows
    for name in j.column_names:
        a, b = j[name], p[name]
        assert a.dtype == b.dtype and a.shape == b.shape, \
            f"{name}: {a.dtype}{a.shape} != {b.dtype}{b.shape}"
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a, b)):
                _same_value(x, y, atol, f"{name}[{i}]")
        else:
            _same_array(a, b, atol, name)
        _same_meta(j.get_meta(name), p.get_meta(name), name)
    assert sorted(j.meta) == sorted(p.meta), (sorted(j.meta), sorted(p.meta))
    for name in j.meta:
        _same_meta(j.meta[name], p.meta[name], name)
