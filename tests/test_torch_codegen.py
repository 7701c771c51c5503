"""The port's binding generator (mmlspark_tpu_torch.codegen) over the
port's registry: tests/test_codegen.py's checks on the port, with the
generated smoke tests run in a subprocess that cannot import JAX or the
JAX package, and the wrappers held against the JAX package's generator
(the same stages, the same accessors, the port's `device` Param aside).
"""
import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmlspark_tpu.codegen import generate as JG
from mmlspark_tpu.core.registry import all_stages as j_all_stages

from mmlspark_tpu_torch.codegen import (camel, generate_r_wrappers,
                                        generate_tests, generate_wrappers)
from mmlspark_tpu_torch.codegen.generate import to_snake
from mmlspark_tpu_torch.core.registry import all_stages

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")
BLOCKER = f"""
import importlib.abc, sys
BLOCKED = {BLOCKED!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
"""


def test_camel_and_snake_match_jax():
    assert camel("num_samples") == "numSamples" and camel("url") == "url"
    for name in ("TabularLIME", "numSamples", "HTTPTransformer", "url"):
        assert to_snake(name) == JG.to_snake(name)
        assert camel(to_snake(name)) == JG.camel(JG.to_snake(name))


def test_registry_is_populated():
    stages = all_stages()
    for expected in ["LightGBMClassifier", "VowpalWabbitClassifier",
                     "TabularLIME", "SAR", "IsolationForest", "TextSentiment",
                     "HTTPTransformer", "SequenceTagger", "AccessAnomaly",
                     "TuneHyperparameters", "ImageFeaturizer", "KNN"]:
        assert expected in stages, f"{expected} missing from registry"
    assert len(stages) == 161
    assert all(c.__module__.startswith("mmlspark_tpu_torch.")
               for c in stages.values())


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gen"))
    pkg = generate_wrappers(out)
    test_file = generate_tests(out)
    return out, pkg, test_file


def _bindings(out):
    import importlib

    sys.path.insert(0, out)
    try:
        return importlib.reload(importlib.import_module(
            "mmlspark_tpu_torch_bindings"))
    finally:
        sys.path.remove(out)


def test_generated_code_imports_the_port_only(generated):
    out, pkg, test_file = generated
    assert os.path.basename(pkg) == "mmlspark_tpu_torch_bindings"
    for path in (os.path.join(pkg, "__init__.py"), test_file):
        tree = ast.parse(open(path).read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in mods if any(m == b or m.startswith(b + ".")
                                           for b in BLOCKED)], (path, mods)
    assert "import mmlspark_tpu_torch" in open(
        os.path.join(pkg, "__init__.py")).read()


def test_generated_package_has_every_stage(generated):
    B = _bindings(generated[0])
    for name in all_stages():
        assert hasattr(B, name), f"wrapper for {name} missing"


def _accessors(src: str) -> dict:
    """class name -> the set of its generated accessor names."""
    out, cur = {}, None
    for line in src.splitlines():
        m = re.match(r"^class (\w+)\(_WrapperBase\):", line)
        if m:
            cur = out.setdefault(m.group(1), set())
        m = re.match(r"^    def ((?:set|get)\w+)\(", line)
        if m and cur is not None:
            cur.add(m.group(1))
    return out


def test_wrappers_match_the_jax_generators(generated, tmp_path):
    ours = _accessors(open(os.path.join(generated[1], "__init__.py")).read())
    jpkg = JG.generate_wrappers(str(tmp_path))
    theirs = _accessors(open(os.path.join(jpkg, "__init__.py")).read())
    assert set(ours) == set(all_stages()) and len(ours) == 161
    # the port's TorchModel is the JAX package's TPUModel; the rest match
    assert set(ours) - set(theirs) == {"TorchModel"}
    assert set(theirs) - set(ours) == {"TPUModel"}
    assert set(j_all_stages()) == set(theirs)
    # ImageFeaturizer's `use_pallas` names the JAX package's Pallas route,
    # which the port has not: its kernels launch whenever it is on the card
    dropped = {"ImageFeaturizer": {"setUsePallas", "getUsePallas"}}
    for name in sorted(set(ours) & set(theirs)):
        extra = ours[name] - theirs[name]
        assert theirs[name] - ours[name] == dropped.get(name, set()), name
        assert extra <= {"setDevice", "getDevice"}, (name, extra)


def test_generated_wrapper_end_to_end(generated):
    import pandas as pd

    B = _bindings(generated[0])
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"a": rng.normal(size=50), "b": rng.normal(size=50)})
    df["label"] = (df["a"] + df["b"] > 0).astype(int)
    est = B.TrainClassifier(inputCols=["a", "b"], labelCol="label",
                            device="cpu")
    assert est.getLabelCol() == "label" and est.getDevice() == "cpu"
    scored = est.fit(df).transform(df)
    assert "prediction" in scored.columns
    assert (scored["prediction"] == df["label"]).mean() > 0.8


def test_generated_smoke_tests_pass_without_jax(generated):
    out, _, test_file = generated
    env = dict(os.environ)
    env["PYTHONPATH"] = out + os.pathsep + ROOT
    script = BLOCKER + (
        "import pytest\n"
        f"rc = pytest.main([{test_file!r}, '-q', '--no-header', '-p', "
        "'no:cacheprovider', '-p', 'no:randomly'])\n"
        "leaked = [m for m in sys.modules if any(m == b or m.startswith(b + "
        "'.') for b in BLOCKED)]\n"
        "assert not leaked, leaked\n"
        "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=300, cwd=out)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "161 passed" in proc.stdout, proc.stdout[-500:]


def _r_function_blocks(src: str):
    blocks, cur = {}, None
    for line in src.splitlines():
        m = re.match(r"^(ml_[a-z0-9_]+) <- function\((.*)\) \{$", line)
        if m:
            cur = m.group(1)
            blocks[cur] = [line]
        elif cur is not None:
            blocks[cur].append(line)
            if line == "}":
                cur = None
    return blocks


def _balanced(path: str) -> str:
    src = open(path).read()
    for ch_open, ch_close in ("()", "{}"):
        assert src.count(ch_open) == src.count(ch_close), path
    assert src.count('"') % 2 == 0
    return src


def test_generated_r_package_structure(tmp_path):
    pkg = generate_r_wrappers(str(tmp_path))
    assert os.path.basename(pkg) == "mmlsparkTpuTorchR"
    src = _balanced(os.path.join(pkg, "R", "stages.R"))
    blocks = _r_function_blocks(src)
    stages = all_stages()
    assert len(blocks) == len(stages)
    exports = set(re.findall(r"export\((ml_[a-z0-9_]+)\)",
                             open(os.path.join(pkg, "NAMESPACE")).read()))
    assert exports == set(blocks)
    for name, cls in stages.items():
        fn = "ml_" + to_snake(name)
        sig = blocks[fn][0]
        for p, spec in cls.params().items():
            if not getattr(spec, "is_complex", False):
                assert f"{camel(p)} = NULL" in sig, (name, p)
        assert f".bindings()${name}" in "\n".join(blocks[fn])
    assert 'reticulate::import("mmlspark_tpu_torch_bindings")' in src


def test_generated_r_smoke_script(tmp_path, generated):
    """The emitted tests/smoke.R bootstraps the port's bindings; its
    Python semantics run here through the generated binding."""
    import pandas as pd

    pkg = generate_r_wrappers(str(tmp_path))
    src = _balanced(os.path.join(pkg, "tests", "smoke.R"))
    assert "from mmlspark_tpu_torch.codegen import generate_wrappers" in src
    assert "mmlspark_tpu.codegen" not in src
    assert "ml_unicode_normalize" in src
    B = _bindings(generated[0])
    out = B.UnicodeNormalize(inputCol="text", outputCol="norm").transform(
        pd.DataFrame({"text": ["a b a", "b c"]}))
    assert "norm" in out.columns and len(out) == 2
