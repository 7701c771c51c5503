"""Discovery by name: the cell, its configuration, its traffic mix, its
driver, its limits and the readers of its metrics.

Everything that belongs to one configuration, one traffic mix, one driver
or one metric sits in a file of its own under the benchmark's folder, and
is found here by the name `BENCHMARK.json` gives it:

    configs/<config>.json    the sizes, as run (BENCHMARK.json's `file`)
    traffic/<mix>.json       the mix's parameters; `driver` names the entry
    drivers/<driver>.py      setup / call / verify of one entry point
    limits/<workload>.json   the limit of each number `correct` compares
    metrics/<metric>.py      one reader a metric, end-to-end or per-layer

So a later change adds a cell, a mix, a configuration or a metric by
adding files and entries, and edits no file that is there.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import List

__all__ = ["BENCH_DIR", "NAME_RE", "UNIT_RE", "load_benchmark", "workload",
           "config", "traffic", "limits", "driver", "metric_reader",
           "metrics_for", "family_module"]

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _checked(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: str) -> dict:
    return _json(path)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str) -> dict:
    """The configuration's file, at the path BENCHMARK.json gives it
    (relative to the checkout's root)."""
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, base: str = BENCH_DIR) -> dict:
    return _json(os.path.join(base, "traffic", _checked(name) + ".json"))


def limits(workload_name: str, base: str = BENCH_DIR) -> dict:
    return _json(os.path.join(base, "limits", _checked(workload_name)
                              + ".json"))


def _module(kind: str, name: str, base: str) -> ModuleType:
    path = os.path.join(base, kind, _checked(name) + ".py")
    mod_name = "perfbench_%s_%s" % (kind, re.sub(r"\W", "_", name))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: str = BENCH_DIR) -> ModuleType:
    return _module("drivers", name, base)


def metric_reader(name: str, base: str = BENCH_DIR) -> ModuleType:
    """The reader of a metric: `metrics/<name>.py`, which states NAME,
    UNIT, BETTER, SOURCE (and for a per-layer metric LAYER and MOVES) and
    defines `read(view)`, returning a number or None when it finds
    nothing to read."""
    mod = _module("metrics", name, base)
    if getattr(mod, "NAME", None) != name:
        raise ValueError(f"metrics/{name}.py states NAME={mod.NAME!r}")
    return mod


def metrics_for(bench: dict, section: str, workload_name: str
                ) -> List[dict]:
    """The entries of `section` ("end_to_end" or "per_layer") that the
    cell reports: those without a `workloads` key, and those that list
    it."""
    return [m for m in bench[section]
            if "workloads" not in m or workload_name in m["workloads"]]


def family_module(cfg: dict) -> ModuleType:
    """The plain reference of the configuration's family
    (`reference/<family>.py`)."""
    return importlib.import_module("perfbench.reference." +
                                   _checked(cfg["family"]))
