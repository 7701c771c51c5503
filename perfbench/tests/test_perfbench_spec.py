"""BENCHMARK.json against the contract, and discovery by name: a config, a
mix and a metric added as new files are found with no edit to a file
that exists."""
import json
import os
import re
import shutil

import pytest

from perfbench.harness import spec
from perfbench.tests import tiny

BENCH = tiny.BENCH
BOTH = pytest.mark.parametrize("bench", [BENCH, tiny.BENCH_ALL],
                               ids=["committed", "with_featurize"])
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
TEXT_RE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}),
])
@BOTH
def test_entry_keys(section, keys, bench):
    for entry in bench[section]:
        assert set(entry) <= keys, entry["name"]
        assert set(entry) >= keys - {"workloads"}, entry["name"]


@BOTH
def test_names_units_and_text(bench):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            assert spec.NAME_RE.match(entry["name"]), entry["name"]
            names.append((section in ("end_to_end", "per_layer"),
                          entry["name"]))
            for key in ("why", "layer"):
                if key in entry:
                    assert TEXT_RE.match(entry[key]), entry[key]
            if section == "configs":
                assert TEXT_RE.match(entry["source"])
            if "unit" in entry:
                assert spec.UNIT_RE.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        for key in ("config", "traffic"):
            assert spec.NAME_RE.match(w[key])
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert spec.NAME_RE.match(k)
            assert not re.search(r"(_dim|_rank|hidden|intermediate|head|"
                                 r"latent|state|expert|projection)", k), k
    assert os.path.getsize(os.path.join(tiny.ROOT, "BENCHMARK.json")) < 65536


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@BOTH
def test_every_cell_reports_what_the_contract_asks(bench):
    for w in bench["workloads"]:
        mine = [m["name"] for m in spec.metrics_for(bench, "end_to_end",
                                                    w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = spec.metrics_for(bench, "per_layer", w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])
        assert any("mfu" in m["name"] for m in layer)


@BOTH
def test_files_of_every_name_exist_and_agree(bench):
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"], tiny.ROOT)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("perfbench/")
    for w in bench["workloads"]:
        mix = spec.traffic(w["traffic"])
        spec.driver(mix["driver"])
        spec.limits(w["name"])
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if m["name"] == "setup_s":
                continue
            mod = spec.metric_reader(m["name"])
            assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
                m["unit"], m["better"], m["source"])
            if section == "per_layer":
                assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
            if "_roofline" in m["name"] or "mfu" in m["name"]:
                assert m["unit"] == "%"
            if "_roofline" in m["name"]:
                assert mod.KERNELS


def test_file_names_are_names():
    for dirpath, _dirs, files in os.walk(spec.BENCH_DIR):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), tiny.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


THROWAWAY_METRIC = '''
NAME = "rows_per_call.featurize"
UNIT = "rows"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "chunk assembly"
MOVES = "images_per_s"


def read(view):
    return sum(c.rec["rows"] for c in view.calls) / len(view.calls)
'''


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    base = tmp_path / "perfbench"
    for kind in ("drivers", "metrics", "traffic", "limits", "configs"):
        shutil.copytree(os.path.join(spec.BENCH_DIR, kind), base / kind)
    wl, cfg, mix = tiny.featurize_parts()
    cfg = dict(cfg, name="resnet_tiny_new")
    (base / "configs" / "resnet_tiny_new.json").write_text(json.dumps(cfg))
    mix = dict(mix, sizes=[[36, 36], [32, 48]])
    (base / "traffic" / "tiny_new_mix.json").write_text(json.dumps(mix))
    (base / "metrics" / "rows_per_call.featurize.py").write_text(
        THROWAWAY_METRIC)
    name = "resnet_tiny_new.tiny_new_mix"
    (base / "limits" / f"{name}.json").write_text(
        json.dumps(tiny.FEATURIZE_LIMITS))
    bench = json.loads(json.dumps(tiny.BENCH_ALL))
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": "perfbench/configs/resnet_tiny_new.json",
                             "reduced": [], "why": "a throwaway"})
    new_wl = {"name": name, "config": cfg["name"], "traffic": "tiny_new_mix",
              "chips": 1, "why": "a throwaway"}
    bench["workloads"].append(new_wl)
    for m in bench["end_to_end"]:
        if "workloads" in m and "resnet50.featurize" in m["workloads"]:
            m["workloads"].append(name)
    bench["per_layer"].append({
        "name": "rows_per_call.featurize", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "chunk assembly",
        "moves": "images_per_s", "workloads": [name]})

    found = spec.config(bench, cfg["name"], str(tmp_path))
    assert found == cfg
    assert spec.traffic("tiny_new_mix", str(base))["sizes"] == [[36, 36],
                                                                 [32, 48]]
    assert spec.metric_reader("rows_per_call.featurize", str(base)).UNIT \
        == "rows"
    assert [m["name"] for m in spec.metrics_for(bench, "per_layer", name)] \
        == ["rows_per_call.featurize"]

    rc, result, _err = tiny.run((new_wl, found, spec.traffic(
        "tiny_new_mix", str(base))), spec.limits(name, str(base)),
        bench=bench, base=str(base))
    assert rc == 0 and result["correct"]
    assert set(result["metrics"]) == {"setup_s", "images_per_s",
                                      "partition_p95_ms"}
    # the per-layer reader runs over the same view
    from perfbench.harness import runner
    view = runner.View(runner.Context(new_wl, found, mix, {}, 1, "cpu",
                                      False),
                       [runner.Call(0.0, 0.1, {"rows": 12})], {}, None, [])
    assert spec.metric_reader("rows_per_call.featurize",
                              str(base)).read(view) == 12
