"""Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX
package, compared by whole top-level name (so `mmlspark_tpu_torch`
passes), and the plain references import nothing of the program."""
import ast
import json
import os
import subprocess
import sys

from perfbench.harness import isolation, spec
from perfbench.tests import tiny


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _files(sub=""):
    for dirpath, _d, files in os.walk(os.path.join(spec.BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_top_level_names_are_compared_whole():
    assert isolation.forbidden_modules(
        ["mmlspark_tpu_torch", "mmlspark_tpu_torch.models", "jaxtyping",
         "flaxen", "numpy"]) == []
    assert isolation.forbidden_modules(
        ["jax.numpy", "jaxlib", "flax.linen", "mmlspark_tpu.models",
         "mmlspark_tpu"]) == ["flax.linen", "jax.numpy", "jaxlib",
                              "mmlspark_tpu", "mmlspark_tpu.models"]


def test_no_source_of_the_benchmark_imports_jax():
    for path in _files():
        for name in _imports(path):
            assert isolation.top_level(name) not in isolation.FORBIDDEN, \
                (path, name)


def test_the_references_import_nothing_of_the_program():
    for path in _files("reference"):
        for name in _imports(path):
            top = isolation.top_level(name)
            assert top in ("__future__", "contextlib", "math", "typing",
                           "numpy", "torch", "perfbench"), (path, name)
            if top == "perfbench":
                assert name.startswith("perfbench.reference"), (path, name)


RUN_BOTH = r"""
import importlib.abc, json, sys, time
FORBIDDEN = {"jax", "jaxlib", "flax", "mmlspark_tpu"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
from perfbench.tests import tiny
out = []
for parts, limits in ((tiny.featurize_parts(), tiny.FEATURIZE_LIMITS),
                      (tiny.finetune_parts(), tiny.FINETUNE_LIMITS)):
    rc, result, err = tiny.run(parts, limits)
    out.append([rc, result["correct"]])
print(json.dumps([out, sorted({m.split(".")[0] for m in sys.modules})]))
"""


def test_a_run_of_either_cell_loads_no_jax():
    code = RUN_BOTH.replace("ROOT", repr(tiny.ROOT))
    env = dict(os.environ, USE_FLAX="0")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=tiny.ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    runs, tops = json.loads(proc.stdout.strip().splitlines()[-1])
    assert runs == [[0, True], [0, True]]
    assert "mmlspark_tpu_torch" in tops
    assert not set(tops) & isolation.FORBIDDEN
