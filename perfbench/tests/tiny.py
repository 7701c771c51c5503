"""Tiny CPU cells for the benchmark's tests: the real drivers, metrics and
references at widths a test run can hold (a two-stage ResNet of
bottleneck blocks, `vit_tiny`), on the program's CPU path."""
from __future__ import annotations

import contextlib
import io
import json
import os
import time

from perfbench.harness import runner, spec

ROOT = os.path.dirname(spec.BENCH_DIR)
BENCH = spec.load_benchmark(os.path.join(ROOT, "BENCHMARK.json"))
RESNET_TINY = "perfbench_resnet_tiny"

# the featurize cell's entries: its files are under the benchmark's folder,
# the cell is not in BENCHMARK.json (PERF.md, open questions); the tests
# run it through a copy of BENCHMARK.json that holds these
FEATURIZE = "resnet50.featurize"
FEATURIZE_ENTRIES = {
    "configs": [{"name": "resnet50",
                 "source": "https://arxiv.org/abs/1512.03385",
                 "file": "perfbench/configs/resnet50.json", "reduced": [],
                 "why": "the featurizer's default backbone"}],
    "workloads": [{"name": FEATURIZE, "config": "resnet50",
                   "traffic": "featurize_p512", "chips": 1,
                   "why": "ImageFeaturizer, closed loop, 512-row partitions"}],
    "end_to_end": [
        {"name": "images_per_s", "unit": "images/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": [FEATURIZE]},
        {"name": "partition_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": [FEATURIZE]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "images_per_s", "workloads": [FEATURIZE]}
        for name, unit, better, source, layer in (
            ("assemble_ms.featurize", "ms", "lower", "program_span",
             "chunk assembly"),
            ("feed_wait_share.featurize", "%", "lower", "program_span",
             "host to device"),
            ("idle_share.featurize", "%", "lower", "device_trace", "device"),
            ("mfu.featurize", "%", "higher", "host_clock", "model step"),
            ("resample_roofline.featurize", "%", "higher", "device_trace",
             "kernel B1"))]}


def with_featurize(bench: dict = BENCH) -> dict:
    """A copy of `bench` that also holds the featurize cell."""
    out = json.loads(json.dumps(bench))
    for key, entries in FEATURIZE_ENTRIES.items():
        out[key] = out[key] + json.loads(json.dumps(entries))
    return out


BENCH_ALL = with_featurize()

# limits for the tiny CPU cells: above what their sound runs read, far
# under what a fault reads
FEATURIZE_LIMITS = {"features_rel_l2": 0.02}
FINETUNE_LIMITS = {"loss_gap": 0.02, "grad_norm_gap": 0.05,
                   "change_norm_gap": 0.05}


def register_builders() -> None:
    from mmlspark_tpu_torch.models import bundle, resnet

    bundle.register_builder(RESNET_TINY, lambda num_classes=10: resnet.ResNet(
        [1, 1], resnet.BottleneckBlock, num_classes))


def _config(name: str) -> dict:
    with open(os.path.join(spec.BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def featurize_parts(base: str = spec.BENCH_DIR):
    register_builders()
    cfg = dict(_config("resnet50"), stage_sizes=[1, 1],
               image_size=[32, 32], num_classes=10,
               port={"builder": RESNET_TINY, "kwargs": {"num_classes": 10}})
    mix = dict(spec.traffic("featurize_p512", base), sizes=[[40, 50], [32, 32]],
               rows_per_size=6, tables=3, batch_size=4,
               sample_rows_per_call=3, traced_calls=2,
               warmup_seconds=0)
    return spec.workload(BENCH_ALL, FEATURIZE), cfg, mix


def finetune_parts(base: str = spec.BENCH_DIR):
    cfg = dict(_config("vit_b16"), hidden_size=192,
               num_attention_heads=3, intermediate_size=768,
               image_size=[32, 32], num_labels=5,
               port={"builder": "vit_tiny", "kwargs": {}})
    mix = dict(spec.traffic("finetune_b128", base), sizes=[[32, 32], [40, 36]],
               rows_per_size=8, classes=5, batch_size=4, epochs=1)
    return spec.workload(BENCH_ALL, "vit_b16.finetune"), cfg, mix


def full_parts(workload: str):
    """(workload, configuration, mix) of a cell at its own size."""
    wl = spec.workload(BENCH_ALL, workload)
    return wl, spec.config(BENCH_ALL, wl["config"], ROOT), spec.traffic(
        wl["traffic"])


def run(parts, limits, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
        bench: dict = BENCH_ALL, base: str = spec.BENCH_DIR,
        trace: bool = False):
    """(exit code, result dict or None, stderr) of one CPU run."""
    wl, cfg, mix = parts
    ctx = runner.Context(wl, cfg, mix, limits, seed, "cpu", trace)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = runner.run_cell(bench, ctx, time.perf_counter(), seconds, base)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
