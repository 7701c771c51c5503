"""Subprocess replica worker of mmlspark_tpu_torch for
tests/test_torch_fleet_obs.py.

Starts one ServingServer of the port (y = 3*v) in its OWN process — its
own telemetry registry, span store and sockets — with `jax`, `flax` and
`mmlspark_tpu` refused at import, prints the bound address (and which of
those names got loaded: none) as one JSON line on stdout, then blocks
until the parent closes stdin.  The counterpart of tests/_fleet_worker.py.
"""
import importlib.abc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCKED = ("jax", "jaxlib", "flax", "mmlspark_tpu")


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if _blocked(name):
            raise ImportError(f"blocked: {name}")
        return None


def main() -> None:
    sys.meta_path.insert(0, _Block())
    import numpy as np

    from mmlspark_tpu_torch.core.pipeline import LambdaTransformer
    from mmlspark_tpu_torch.serving import ServingServer

    def fn(table):
        v = np.asarray(table["v"], np.int64)
        return table.with_column("y", v * 3)

    srv = ServingServer(
        LambdaTransformer(fn), reply_col="y", name="fleet-worker",
        host="127.0.0.1", port=0, input_schema=["v"],
        max_batch=8, batch_timeout_ms=5.0)
    srv.server.handler_timeout = 1.5
    info = srv.start()
    print(json.dumps({"name": info.name, "host": info.host,
                      "port": info.port, "path": info.path,
                      "blocked_loaded": sorted(
                          m for m in sys.modules if _blocked(m))}),
          flush=True)
    try:
        sys.stdin.read()  # parent closes our stdin to shut us down
    finally:
        srv.stop(drain=False)


if __name__ == "__main__":
    main()
