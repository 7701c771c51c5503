"""Readings for the limits of `correct`, at a cell's own size.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--calls N]

For each of `--seeds` it builds the cell from that seed (set-up and its
warm-up), runs `--calls` more calls and prints the numbers `verify`
compares: the program's readings.  For each of `--control-seeds` it puts
the reference computed in fp8 (e4m3, one scale a tensor; the step below
the configuration's bfloat16) in the program's place: the control's
readings.  For each of `--fault-seeds` it plants each fault of
`faults.py` in the program and reads again.  One JSON line a reading on
standard output.  The benchmark's runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--calls", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import faults
    from perfbench.harness import runner, spec
    from perfbench.reference.precision import fp8_e4m3

    bench = spec.load_benchmark(os.path.join(ROOT, "BENCHMARK.json"))
    wl = spec.workload(bench, args.workload)
    cfg = spec.config(bench, wl["config"], ROOT)
    mix = spec.traffic(wl["traffic"])
    drv = spec.driver(mix["driver"])
    limits = {k: float("inf") for k in spec.limits(wl["name"])}

    def reading(kind, seed, fault=None):
        t0 = time.perf_counter()
        ctx = runner.Context(wl, cfg, mix, limits, seed, args.device, False)
        cell = drv.setup(ctx)
        for _ in range(args.calls):
            cell.call()
        cell.release()
        checks = cell.verify(fp8_e4m3 if kind == "control" else None)
        print(json.dumps({"kind": kind, "fault": fault, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "numbers": {n: v for n, v, _l in checks},
                          "left_out": getattr(cell, "left_out", None)}),
              flush=True)

    for seed in args.seeds:
        reading("program", seed)
    for seed in args.control_seeds:
        reading("control", seed)
    for seed in args.fault_seeds:
        for fault in faults.FAULTS[mix["driver"]]:
            with faults.plant(mix["driver"], fault):
                reading("fault", seed, fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
