"""Binding autogenerator: reflect over the stage registry, emit wrappers.

Reference: core codegen/ (L7) — `Wrappable` (codegen/Wrappable.scala:92-391)
reflects over every stage's Params to emit a full PySpark class (camelCase
setters/getters with TypeConverters, fit/transform bridging, _from_java) and
an R wrapper; `CodeGen.main` (CodeGen.scala:194) walks the jar via
`JarLoadingUtils.instantiateServices` and writes the package tree; sbt
`testgen` emits smoke tests per stage.

Here the registry (core/registry.py) plays the role of jar reflection: for
every registered stage we emit a camelCase wrapper class operating on pandas
DataFrames (the pyspark-idiomatic API surface MMLSpark users know), plus a
generated smoke test per stage.

A copy of the JAX package's `codegen/generate.py` for this package: it
reflects over this package's registry, and the emitted wrappers, R
package and smoke tests import `mmlspark_tpu_torch` (never JAX or the JAX
package).  The generated packages are named `mmlspark_tpu_torch_bindings`
and `mmlsparkTpuTorchR`, so that they stand beside the JAX package's.
"""
from __future__ import annotations

import os
from typing import Dict, List, Type

from ..core.params import Param
from ..core.pipeline import Estimator, Transformer
from ..core.registry import all_stages

__all__ = ["generate_wrappers", "generate_tests", "generate_r_wrappers",
           "camel"]

_HEADER = '''"""AUTOGENERATED by mmlspark_tpu_torch.codegen.generate — do not edit.

PySpark-style camelCase wrappers over the native stage registry: each class
wraps a registered stage, accepts/returns pandas DataFrames, and exposes
setX/getX accessors (reference: autogenerated wrappers of
codegen/Wrappable.scala:92-391).
"""
import mmlspark_tpu_torch  # noqa: F401
from mmlspark_tpu_torch.codegen.generate import to_snake as _to_snake
from mmlspark_tpu_torch.core.registry import get_stage_class
from mmlspark_tpu_torch.core.schema import Table


class _WrapperBase:
    _stage_name = None

    def __init__(self, **kwargs):
        cls = get_stage_class(self._stage_name)
        snake = {_to_snake(k): v for k, v in kwargs.items()}
        self._stage = cls(**snake)

    @classmethod
    def _from_stage(cls, stage):
        obj = cls.__new__(cls)
        obj._stage = stage
        return obj

    @property
    def stage(self):
        return self._stage

    def fit(self, df):
        model = self._stage.fit(_to_table(df))
        return _wrap(model)

    def transform(self, df):
        return self._stage.transform(_to_table(df)).to_pandas()

    def save(self, path, overwrite=True):
        self._stage.save(path, overwrite=overwrite)

    @classmethod
    def load(cls, path):
        from mmlspark_tpu_torch.core.pipeline import PipelineStage

        return _wrap(PipelineStage.load(path))

    def __repr__(self):
        return f"{type(self).__name__}<{self._stage!r}>"


def _to_table(df):
    if isinstance(df, Table):
        return df
    return Table.from_pandas(df)


def _wrap(stage):
    name = type(stage).__name__
    cls = globals().get(name)
    if cls is None:
        return stage
    return cls._from_stage(stage)

'''


def camel(snake: str) -> str:
    parts = snake.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def to_snake(name: str) -> str:
    """camelCase/CamelCase -> snake_case (the ONE implementation: used here
    and imported by the generated bindings package)."""
    out = []
    for c in name:
        if c.isupper():
            out.append("_")
            out.append(c.lower())
        else:
            out.append(c)
    s = "".join(out)
    return s[1:] if s.startswith("_") else s


def _accessors(name: str, params: Dict[str, Param]) -> List[str]:
    lines = []
    for pname in sorted(params):
        cap = camel(pname)
        cap = cap[0].upper() + cap[1:]
        lines.append(f"    def set{cap}(self, value):")
        lines.append(f"        self._stage.set({pname}=value)")
        lines.append("        return self")
        lines.append("")
        lines.append(f"    def get{cap}(self):")
        lines.append(f"        return self._stage.get_or_default({pname!r})")
        lines.append("")
    return lines


def generate_wrappers(out_dir: str,
                      package_name: str = "mmlspark_tpu_torch_bindings") -> str:
    """Write the generated package; returns its path."""
    stages = all_stages()
    pkg = os.path.join(out_dir, package_name)
    os.makedirs(pkg, exist_ok=True)
    lines = [_HEADER]
    names = []
    for name, cls in sorted(stages.items()):
        params = cls.params()
        kind = "Estimator" if issubclass(cls, Estimator) else "Transformer"
        doc = (cls.__doc__ or "").strip().splitlines()
        summary = doc[0] if doc else name
        lines.append(f"class {name}(_WrapperBase):")
        # repr-escaped: docstrings may contain quotes/backslashes
        lines.append(f"    __doc__ = {f'{kind} wrapper: {summary}'!r}")
        lines.append(f"    _stage_name = {name!r}")
        lines.append("")
        lines.extend(_accessors(name, params))
        if not issubclass(cls, Estimator):
            lines.append("    fit = None  # transformer-only stage")
            lines.append("")
        names.append(name)
    lines.append(f"__all__ = {names!r}")
    with open(os.path.join(pkg, "__init__.py"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return pkg


def generate_r_wrappers(out_dir: str,
                        package_name: str = "mmlsparkTpuTorchR") -> str:
    """Emit the sparklyr-style R package (reference Wrappable.scala:393-512):
    one constructor function per stage, bridging to Python via reticulate.
    Returns the package path."""
    stages = all_stages()
    pkg = os.path.join(out_dir, package_name)
    os.makedirs(os.path.join(pkg, "R"), exist_ok=True)
    lines = [
        "# AUTOGENERATED by mmlspark_tpu_torch.codegen.generate - do not edit.",
        "# Each constructor returns a wrapped stage; fit/transform accept",
        "# data.frames (converted through reticulate/pandas).",
        ".mmlspark_env <- new.env()",
        "",
        ".bindings <- function() {",
        "  if (is.null(.mmlspark_env$mod)) {",
        '    .mmlspark_env$mod <- reticulate::import("mmlspark_tpu_torch_bindings")',
        "  }",
        "  .mmlspark_env$mod",
        "}",
        "",
    ]
    fn_names = []
    for name, cls in sorted(stages.items()):
        params = [p for p, spec in cls.params().items()
                  if not getattr(spec, "is_complex", False)]
        fn = "ml_" + to_snake(name)
        fn_names.append(fn)
        args = ", ".join([f"{camel(p)} = NULL" for p in params])
        lines.append(f"{fn} <- function({args}) {{")
        lines.append("  kwargs <- list(")
        lines.append(
            "    " + ", ".join(f"{camel(p)} = {camel(p)}" for p in params)
        )
        lines.append("  )")
        lines.append("  kwargs <- Filter(Negate(is.null), kwargs)")
        lines.append(f'  do.call(.bindings()${name}, kwargs)')
        lines.append("}")
        lines.append("")
    with open(os.path.join(pkg, "R", "stages.R"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(pkg, "DESCRIPTION"), "w") as f:
        f.write(
            f"Package: {package_name}\n"
            "Type: Package\n"
            "Title: ML pipeline stages on PyTorch and CUDA\n"
            "Version: 0.1.0\n"
            "Imports: reticulate\n"
        )
    with open(os.path.join(pkg, "NAMESPACE"), "w") as f:
        f.writelines(f"export({fn})\n" for fn in fn_names)
    # executable evidence for the reference's testR discipline
    # (CodegenPlugin.scala:60): a self-contained end-to-end smoke —
    # construct a stage through a generated wrapper, transform a
    # data.frame, assert the output column.  This CI image ships no R
    # interpreter (recorded descope, README "Bindings"), so the script
    # is EMITTED and parse-gated here and runs wherever R + reticulate
    # exist: `Rscript tests/smoke.R` from the package root.
    os.makedirs(os.path.join(pkg, "tests"), exist_ok=True)
    with open(os.path.join(pkg, "tests", "smoke.R"), "w") as f:
        f.write("\n".join([
            "# AUTOGENERATED end-to-end smoke: run with Rscript from the",
            "# package root.  Prerequisites: reticulate + a Python whose",
            "# sys.path can import mmlspark_tpu_torch.  The generated",
            "# mmlspark_tpu_torch_bindings package reticulate dispatches to",
            "# is",
            "# (re)generated HERE into a temp dir — the script is",
            "# self-sufficient, no separately-installed bindings needed.",
            'reticulate::py_run_string(paste(',
            '  "import sys, tempfile",',
            '  "from mmlspark_tpu_torch.codegen import generate_wrappers",',
            '  "d = tempfile.mkdtemp()",',
            '  "generate_wrappers(d)",',
            '  "sys.path.insert(0, d)",',
            '  sep = "\\n"))',
            'source(file.path("R", "stages.R"))',
            "df <- data.frame(text = c(\"a b a\", \"b c\"))",
            'stage <- ml_unicode_normalize(inputCol = "text",',
            '                              outputCol = "norm")',
            "out <- stage$transform(df)",
            'stopifnot("norm" %in% colnames(out))',
            "stopifnot(nrow(out) == 2)",
            'cat("R smoke ok\\n")',
            "",
        ]))
    return pkg


def generate_tests(out_dir: str,
                   package_name: str = "mmlspark_tpu_torch_bindings") -> str:
    """Emit the testgen analog: one smoke test per generated wrapper
    (construct, accessor round-trip)."""
    stages = all_stages()
    path = os.path.join(out_dir, f"test_{package_name}_smoke.py")
    lines = [
        '"""AUTOGENERATED smoke tests (sbt testgen analog)."""',
        f"import {package_name} as B",
        "",
    ]
    for name, cls in sorted(stages.items()):
        simple = {
            n: p for n, p in cls.params().items()
            if not getattr(p, "is_complex", False) and p.has_default
            and isinstance(p.default, (int, float, str, bool))
        }
        lines.append(f"def test_{name}_smoke():")
        lines.append(f"    w = B.{name}()")
        if simple:
            pname = sorted(simple)[0]
            cap = camel(pname)
            cap = cap[0].upper() + cap[1:]
            default = simple[pname].default
            lines.append(f"    assert w.get{cap}() == {default!r}")
            lines.append(f"    w.set{cap}({default!r})")
            lines.append(f"    assert w.get{cap}() == {default!r}")
        else:
            lines.append("    assert w.stage is not None")
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
