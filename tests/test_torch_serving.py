"""The port's one-call LM endpoint on the CPU:
`read_stream().continuous_server(...).generate_stream(bundle, ...)`
(mmlspark_tpu_torch.serving) owns a ContinuousBatcher, streams tokens to
concurrent HTTP clients, and stops the batcher with the query — the JAX
suite's test_generate_stream_one_call_endpoint on bridged weights, with
every stream held against the JAX package's `generate`."""
import functools
import http.client
import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models.generation import generate as j_generate
from mmlspark_tpu.models.transformer import transformer_lm
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.serving import (DistributedServingServer,
                                        ServiceRegistry, list_services,
                                        read_stream)

torch.set_num_threads(2)

N = 5
PROMPTS = [[3, 1, 4], [9, 8, 2], [2, 2, 7, 5]]


@functools.lru_cache(maxsize=None)
def _lm():
    kw = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=2,
              max_len=48)
    model = transformer_lm(dtype=jnp.float32, **kw)
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 4), jnp.int32), train=False)
    variables = {"params": jax.tree.map(np.asarray, variables["params"])}
    return model, variables, from_flax_variables("transformer_lm", variables,
                                                 kw, dtype="float32")


def _reference(prompt):
    model, variables, _bundle = _lm()
    out = j_generate(model, variables, jnp.asarray(prompt)[None],
                     max_new_tokens=N)
    return np.asarray(out)[0, len(prompt):].tolist()


def _post_all(info, path, bodies):
    results = [None] * len(bodies)

    def client(i):
        conn = http.client.HTTPConnection(info.host, info.port, timeout=60)
        conn.request("POST", path, body=json.dumps(bodies[i]).encode())
        resp = conn.getresponse()
        results[i] = (resp.status, resp.read().decode())
        conn.close()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return results


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_generate_stream_one_call_endpoint(paged):
    query = (read_stream()
             .continuous_server(name="gen1call", path="/lm")
             .parse_request(schema=["prompt"])
             .generate_stream(_lm()[2], max_new_tokens=N, max_slots=2,
                              paged=paged, page_size=8, device="cpu")
             .options(batch_timeout_ms=5.0)
             .start())
    try:
        results = _post_all(query.service_info, "/lm",
                            [{"prompt": p} for p in PROMPTS])
        # the server's own observability endpoints answer too
        conn = http.client.HTTPConnection(query.service_info.host,
                                          query.service_info.port, timeout=30)
        conn.request("GET", "/metrics")
        metrics = conn.getresponse().read().decode()
        conn.close()
    finally:
        query.stop()
    for p, (status, body) in zip(PROMPTS, results):
        assert status == 200
        assert [int(t) for t in body.split()] == _reference(p), p
    assert "serving_batcher_batch_fill_count" in metrics
    # stop() also stopped the BATCHER, not just the server
    assert not query.is_active()
    assert not query._batcher._running.is_set()
    assert not query._batcher._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        query._batcher.submit([1, 2], max_new_tokens=2)


def test_unported_serving_forms_raise():
    """The multi-replica forms, which raised until the fleet layers were
    ported, start and answer: `distributed_server(replicas=2)`, a
    one-replica `distributed_server` with a registry, and
    `DistributedServingServer` (tests/test_torch_fleet.py holds them
    behind a gateway)."""
    reg = ServiceRegistry()
    url = reg.start()
    try:
        for replicas, registry_url in ((2, None), (1, url)):
            query = (read_stream()
                     .distributed_server(name="multi", path="/lm",
                                         replicas=replicas,
                                         registry_url=registry_url)
                     .parse_request(schema=["prompt"])
                     .generate_stream(_lm()[2], max_new_tokens=N,
                                      max_slots=2, device="cpu")
                     .start())
            try:
                assert len(query.service_infos) == replicas
                for info in query.service_infos:
                    (status, body), = _post_all(info, "/lm",
                                                [{"prompt": PROMPTS[1]}])
                    assert status == 200
                    assert [int(t) for t in body.split()] == \
                        _reference(PROMPTS[1])
            finally:
                query.stop()
        assert [e["port"] for e in list_services(url, "multi")] == [
            query.service_info.port]
    finally:
        reg.stop()
    dss = DistributedServingServer(
        model=lambda t: t.with_column("y", np.asarray(t["x"]) * 2),
        reply_col="y", name="dss", replicas=2)
    try:
        for info in dss.start():
            (status, body), = _post_all(info, "/", [{"x": 4}])
            assert status == 200 and json.loads(body) == {"y": 8}
    finally:
        dss.stop()
    # speculative generate_stream, which raised until the speculative
    # batcher was ported, starts and answers with generate()'s tokens
    # (tests/test_torch_speculative.py holds it against the JAX package
    # over pools and co-tenants)
    query = (read_stream().continuous_server(name="spec", path="/s")
             .parse_request(schema=["prompt"])
             .generate_stream(_lm()[2], draft_model=_lm()[2], gamma=2,
                              max_new_tokens=N, device="cpu")
             .start())
    try:
        assert query._batcher.draft is not None and query._batcher.gamma == 2
        results = _post_all(query.service_info, "/s",
                            [{"prompt": PROMPTS[0]}])
    finally:
        query.stop()
    assert results[0][0] == 200
    assert [int(t) for t in results[0][1].split()] == _reference(PROMPTS[0])
