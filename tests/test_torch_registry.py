"""The port's stage registry lists every module that registers a stage.

`core/registry.STAGE_MODULES` is what `get_stage_class` and `all_stages`
import to fill the registry; a module that carries `@register_stage` but
is missing from the list leaves its stages unknown to a fresh
interpreter (a saved pipeline that names them does not load).  Two
checks: an AST scan of `mmlspark_tpu_torch/` for every module with a
`@register_stage` class, against the list; and, in a fresh subprocess,
`get_stage_class` of the deep-vision stages (the ones the list missed).
"""
import ast
import os
import subprocess
import sys

import pytest

from mmlspark_tpu_torch.core import registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mmlspark_tpu_torch")


def _is_register_stage(dec: ast.expr) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    name = target.attr if isinstance(target, ast.Attribute) else \
        getattr(target, "id", None)
    return name == "register_stage"


def _registering_modules():
    """module name -> the classes it decorates with `@register_stage`."""
    out = {}
    for d, _subdirs, files in os.walk(PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
            classes = [n.name for n in ast.walk(tree)
                       if isinstance(n, ast.ClassDef)
                       and any(_is_register_stage(x) for x in n.decorator_list)]
            if classes:
                rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
                out[rel] = classes
    return out


def test_the_scan_finds_the_known_stage_modules():
    mods = _registering_modules()
    for m, cls in (("mmlspark_tpu_torch.models.torch_model", "TorchModel"),
                   ("mmlspark_tpu_torch.models.deep_vision",
                    "DeepVisionClassifier"),
                   ("mmlspark_tpu_torch.ops.image_stages", "UnrollImage")):
        assert cls in mods.get(m, []), (m, cls, mods)


@pytest.mark.parametrize("module", sorted(_registering_modules()))
def test_every_registering_module_is_in_stage_modules(module):
    assert module in registry.STAGE_MODULES, (
        f"{module} registers {_registering_modules()[module]} but is not in "
        f"core/registry.STAGE_MODULES")


@pytest.mark.parametrize("name", ["DeepVisionClassifier", "DeepVisionModel"])
def test_get_stage_class_resolves_in_a_fresh_interpreter(name):
    script = (
        "from mmlspark_tpu_torch.core import registry\n"
        f"cls = registry.get_stage_class({name!r})\n"
        "assert cls.__module__ == 'mmlspark_tpu_torch.models.deep_vision', "
        "cls.__module__\n"
        f"assert {name!r} in registry.all_stages()\n"
        "print('ok', cls.__name__)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == f"ok {name}", \
        proc.stdout + proc.stderr
