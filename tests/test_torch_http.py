"""The port's HTTP-on-tables layer on the CPU: clients, the circuit
breaker, the two HTTP transformer stages and their parsers, the service
registry and the SSH forwarding command, held against the JAX package.

The scenarios of the JAX suite's tests/test_http_serving.py (the
client, transformer, registry and forwarding tests) run over
`mmlspark_tpu_torch`; where both packages compute something from the
same inputs (a stage's output columns against one echo server, a
breaker's state sequence under one scripted run, a forwarding command)
the two answers must be equal.
"""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import LambdaTransformer, Table
from mmlspark_tpu_torch.core import shared, telemetry
from mmlspark_tpu_torch.io.http import (
    AsyncHTTPClient,
    HandlingUtils,
    HTTPRequestData,
    HTTPResponseData,
    HTTPTransformer,
    JSONOutputParser,
    SimpleHTTPTransformer,
    StringOutputParser,
    send_request,
    to_http_request,
)
from mmlspark_tpu_torch.io.http.clients import (CircuitBreaker, get_breaker,
                                                get_shared_client)
from mmlspark_tpu_torch.serving import (
    ServiceRegistry,
    ServingServer,
    list_services,
    register_service,
)

torch.set_num_threads(2)


# ---------------------------------------------------------------- echo server
class _EchoHandler(BaseHTTPRequestHandler):
    fail_next = {"count": 0, "status": 503}

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if _EchoHandler.fail_next["count"] > 0:
            _EchoHandler.fail_next["count"] -= 1
            self.send_response(_EchoHandler.fail_next["status"])
            if _EchoHandler.fail_next["status"] == 429:
                self.send_header("Retry-After", "0.01")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        payload = json.loads(body or b"{}")
        out = json.dumps({"echo": payload}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def echo_url():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _EchoHandler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    host, port = httpd.server_address[:2]
    yield f"http://{host}:{port}/"
    httpd.shutdown()
    httpd.server_close()


def _double_fn(table):
    return table.with_column("out", np.asarray(table["x"], np.float64) * 2)


# ------------------------------------------------------------ the clients

def test_send_request_roundtrip(echo_url):
    resp = send_request(to_http_request(echo_url, {"x": 1}))
    assert resp.ok and resp.json() == {"echo": {"x": 1}}


def test_retry_on_503(echo_url):
    _EchoHandler.fail_next = {"count": 2, "status": 503}
    resp = HandlingUtils.advanced(
        to_http_request(echo_url, {"y": 2}), backoffs_ms=(10, 10, 10))
    assert resp.ok


def test_retry_honors_429(echo_url):
    _EchoHandler.fail_next = {"count": 1, "status": 429}
    resp = HandlingUtils.advanced(
        to_http_request(echo_url, {"z": 3}), backoffs_ms=(10, 10))
    assert resp.ok


def test_connection_refused_returns_status_zero():
    resp = send_request(HTTPRequestData(url="http://127.0.0.1:1/nope"),
                        timeout=2.0)
    assert resp.status_code == 0 and resp.reason


def test_async_client_ordered(echo_url):
    client = AsyncHTTPClient(concurrency=4)
    reqs = [to_http_request(echo_url, {"i": i}) for i in range(10)]
    reqs.insert(3, None)
    resps = client.send_all(reqs)
    assert resps[3] is None
    values = [r.json()["echo"]["i"] for r in resps if r is not None]
    assert values == list(range(10))


def test_shared_client_is_one_per_config_until_reset():
    a = get_shared_client(3, 7.0)
    assert get_shared_client(3, 7.0) is a
    assert get_shared_client(4, 7.0) is not a
    shared.reset_singletons()
    assert get_shared_client(3, 7.0) is not a


def test_send_request_carries_the_current_trace(echo_url):
    seen = {}

    class H(_EchoHandler):
        def do_POST(self):
            seen.update(self.headers.items())
            super().do_POST()

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        host, port = httpd.server_address[:2]
        with telemetry.span("client.call") as sp:
            assert send_request(to_http_request(
                f"http://{host}:{port}/", {"x": 1})).ok
        assert seen[telemetry.TRACE_HEADER] == sp.trace_id
        assert seen[telemetry.SPAN_HEADER] == sp.span_id
    finally:
        httpd.shutdown()
        httpd.server_close()


# ----------------------------------------------- the circuit breaker, held
# against the JAX package's on one scripted run

_SCRIPT = [
    ("record", False), ("record", False), ("allow", None),
    ("record", False),                       # third failure opens
    ("allow", None), ("tick", 4.0), ("allow", None), ("retry", None),
    ("tick", 2.0), ("allow", None),          # half-open: one probe
    ("allow", None),                         # second caller refused
    ("record", False),                       # probe fails: open again
    ("tick", 6.0), ("allow", None), ("record", True),   # closes
    ("allow", None), ("record", False), ("record", True), ("record", False),
]


def _run_breaker(cls):
    t = {"now": 100.0}
    br = cls("script", failure_threshold=3, reset_timeout_s=5.0,
             clock=lambda: t["now"])
    out = []
    for op, arg in _SCRIPT:
        if op == "record":
            br.record(arg)
            out.append(("record", br.state))
        elif op == "allow":
            out.append(("allow", br.allow(), br.state))
        elif op == "retry":
            out.append(("retry", round(br.retry_after_s(), 9)))
        else:
            t["now"] += arg
    return out


def test_circuit_breaker_states_match_the_jax_package():
    from mmlspark_tpu.io.http.clients import CircuitBreaker as JBreaker

    got, want = _run_breaker(CircuitBreaker), _run_breaker(JBreaker)
    assert got == want
    states = [s[-1] for s in got]
    assert {"closed", "open", "half_open"} <= set(states)


def test_circuit_breaker_counts_its_transitions():
    name = "cb-count"
    before = telemetry.counters("circuit.")
    br = get_breaker(name, failure_threshold=1, reset_timeout_s=0.0)
    assert get_breaker(name) is br
    br.record(False)
    assert br.allow() and br.state == "half_open"
    br.record(True)
    after = telemetry.counters("circuit.")
    for key in (f"circuit.open.{name}", f"circuit.half_open_probe.{name}",
                f"circuit.closed.{name}"):
        assert after.get(key, 0) == before.get(key, 0) + 1, key
    with pytest.raises(ValueError):
        CircuitBreaker("bad", failure_threshold=0)


# ------------------------------------------------------ the HTTP stages

def test_http_transformer(echo_url):
    reqs = np.empty(3, dtype=object)
    for i in range(3):
        reqs[i] = to_http_request(echo_url, {"row": i})
    out = HTTPTransformer().transform(Table({"request": reqs}))
    assert [r.json()["echo"]["row"] for r in out["response"]] == [0, 1, 2]


def test_simple_http_transformer(echo_url):
    t = Table({"a": np.array([1, 2]), "b": ["u", "v"]})
    out = SimpleHTTPTransformer(input_cols=["a", "b"], url=echo_url,
                                output_col="result").transform(t)
    assert out["result"][0] == {"echo": {"a": 1, "b": "u"}}
    assert out["errors"][0] is None
    assert "request" not in out.column_names


def test_simple_http_transformer_error_column(echo_url):
    _EchoHandler.fail_next = {"count": 99, "status": 404}
    try:
        out = SimpleHTTPTransformer(
            input_cols=["a"], url=echo_url, output_col="result"
        ).transform(Table({"a": np.array([7])}))
        assert out["result"][0] is None
        assert out["errors"][0].startswith("404")
    finally:
        _EchoHandler.fail_next = {"count": 0, "status": 503}


def _columns(table):
    def plain(v):
        if hasattr(v, "status_code"):       # a response of either package
            return (v.status_code, v.entity)
        if hasattr(v, "url") and hasattr(v, "entity"):
            return (v.url, v.method, v.entity)
        if isinstance(v, np.generic):
            return v.item()
        return v

    return {c: [plain(v) for v in table[c]] for c in table.column_names}


_STAGES = {
    "simple": lambda m, url: m.SimpleHTTPTransformer(
        input_cols=["a", "b"], url=url, output_col="result", concurrency=3),
    "simple_no_errors": lambda m, url: m.SimpleHTTPTransformer(
        input_cols=["a"], url=url, error_col=""),
    "simple_string": lambda m, url: m.SimpleHTTPTransformer(
        input_cols=["b"], url=url, output_parser=m.StringOutputParser()),
    "json_input": lambda m, url: m.JSONInputParser(
        input_cols=["a", "b"], url=url),
}


@pytest.mark.parametrize("case", sorted(_STAGES))
def test_http_stage_columns_match_the_jax_package(echo_url, case):
    from mmlspark_tpu import Table as JTable
    from mmlspark_tpu.io.http import transformers as jt

    from mmlspark_tpu_torch.io.http import transformers as pt

    a, b = np.array([3, 1, 4, 1]), ["x", "y", "z", "w"]
    got = _STAGES[case](pt, echo_url).transform(Table({"a": a, "b": b}))
    want = _STAGES[case](jt, echo_url).transform(JTable({"a": a, "b": b}))
    assert got.column_names == want.column_names
    assert _columns(got) == _columns(want)


def test_output_parsers_match_the_jax_package():
    from mmlspark_tpu import Table as JTable
    from mmlspark_tpu.io.http import transformers as jt
    from mmlspark_tpu.io.http.schema import HTTPResponseData as JResp

    def table(T, R):
        resps = np.empty(4, object)
        for i, (code, body) in enumerate([(200, b'{"v": 1}'), (500, b"x"),
                                          (200, b"not json"),
                                          (201, b'[1, 2]')]):
            resps[i] = R(status_code=code, reason="r", headers={},
                         entity=body)
        return T({"response": resps})

    for p_cls, j_cls in ((JSONOutputParser, jt.JSONOutputParser),
                         (StringOutputParser, jt.StringOutputParser)):
        got = p_cls().transform(table(Table, HTTPResponseData))
        want = j_cls().transform(table(JTable, JResp))
        assert list(got["output"]) == list(want["output"]), p_cls.__name__


# ---------------------------------------------- registry and forwarding

def test_registry_roundtrip():
    reg = ServiceRegistry()
    url = reg.start()
    try:
        srv = ServingServer(model=LambdaTransformer(_double_fn),
                            reply_col="out", name="svc", path="/svc")
        info = srv.start()
        try:
            assert register_service(url, info)
            listed = list_services(url, "svc")
            assert len(listed) == 1
            assert listed[0]["port"] == info.port
            # full discovery -> request path
            resp = send_request(to_http_request(
                f"http://{listed[0]['host']}:{listed[0]['port']}"
                f"{listed[0]['path']}", {"x": 5}), timeout=10)
            assert resp.json() == {"out": 10.0}
        finally:
            srv.stop()
    finally:
        reg.stop()


_FORWARDS = [
    (("bastion.example.com", 8080, 5000), dict(user="svc",
                                               key_file="/k.pem")),
    (("h", 9000, 5001), dict(reverse=False)),
    (("h", 9000, 5001), dict(user="u", ssh_port=2222)),
]


@pytest.mark.parametrize("args,kw", _FORWARDS)
def test_port_forwarding_command_matches_the_jax_package(args, kw):
    from mmlspark_tpu.serving.port_forwarding import \
        forwarding_command as j_cmd

    from mmlspark_tpu_torch.serving.port_forwarding import forwarding_command

    assert forwarding_command(*args, **kw) == j_cmd(*args, **kw)


def test_port_forwarding_command():
    from mmlspark_tpu_torch.serving.port_forwarding import forwarding_command

    cmd = forwarding_command("bastion.example.com", 8080, 5000,
                             user="svc", key_file="/k.pem")
    assert cmd[0] == "ssh" and "-R" in cmd
    assert "8080:127.0.0.1:5000" in cmd
    assert cmd[-1] == "svc@bastion.example.com"
    cmd2 = forwarding_command("h", 9000, 5001, reverse=False)
    assert "-L" in cmd2 and "5001:127.0.0.1:9000" in cmd2
