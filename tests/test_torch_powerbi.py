"""The port's PowerBI writer (mmlspark_tpu_torch.io.powerbi) against a
local server: tests/test_io_extras.py's PowerBI checks on the port, and
the two packages' writers posting the same batches, body for body, from
the same table.  Host code over the port's `HandlingUtils`; nothing runs
on a device.
"""
import contextlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.io.powerbi import write_to_power_bi as j_write

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.io.powerbi import write_to_power_bi


@contextlib.contextmanager
def server(status=200):
    received = []

    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            received.append(self.rfile.read(n))
            self.send_response(status)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    host, port = httpd.server_address[:2]
    try:
        yield f"http://{host}:{port}/", received
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_power_bi_writer():
    with server() as (url, received):
        t = Table({"x": np.arange(7), "name": [f"r{i}" for i in range(7)]})
        assert write_to_power_bi(t, url, batch_size=3) == 7
    assert len(received) == 3  # 3+3+1
    assert json.loads(received[0])[0] == {"x": 0, "name": "r0"}


def test_power_bi_nan_becomes_null():
    with server() as (url, received):
        t = Table({"x": np.array([1.0, np.nan, np.inf])})
        assert write_to_power_bi(t, url) == 3
    rows = json.loads(received[0])
    assert rows[1] == {"x": None} and rows[2] == {"x": None}


def test_power_bi_refused_batch_raises():
    with server(status=400) as (url, _):
        with pytest.raises(RuntimeError, match="batch 0: 400"):
            write_to_power_bi(Table({"x": np.arange(3)}), url)


def test_power_bi_batches_equal_the_jax_packages():
    vec = np.empty(5, dtype=object)
    for i in range(5):
        vec[i] = np.arange(i, dtype=np.float32) / 3
    cols = {"i": np.arange(5, dtype=np.int64),
            "f": np.array([0.5, np.nan, -1e300, 2.0, np.inf]),
            "s": np.asarray(["a", "b", "c", "d", "e"], object),
            "v": vec}
    bodies = []
    for write, table in ((j_write, JTable), (write_to_power_bi, Table)):
        with server() as (url, received):
            assert write(table(dict(cols)), url, batch_size=2) == 5
        bodies.append(received)
    assert bodies[0] == bodies[1] and len(bodies[1]) == 3
