"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, the benchmark's
folder and the program (`mmlspark_tpu_torch`).  The last line of standard
output is the result (JSON); the last lines of standard error are the
numbers compared with the plain reference, each beside its limit.  Exits
with 3 and prints no result when the cell's cards are not there, with 4
when the process loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Caches inside the checkout, at fixed paths (the program builds its
    own kernels into its package's `csrc/build/`); no library loads JAX
    on its own."""
    cache = os.path.join(ROOT, "build", "perfbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number")

    _environment()
    sys.path.insert(0, ROOT)
    from perfbench.harness import device, runner, spec

    bench = spec.load_benchmark(os.path.join(ROOT, "BENCHMARK.json"))
    wl = spec.workload(bench, args.workload)
    try:
        device.require_cards(int(wl["chips"]))
    except device.NoCards as e:
        device.log(f"perfbench: {e}")
        return 3
    device.log(f"perfbench: {device.power_limit()}")
    mix = spec.traffic(wl["traffic"])
    ctx = runner.Context(wl, spec.config(bench, wl["config"], ROOT), mix,
                         spec.limits(wl["name"]), args.seed, "cuda",
                         bool(args.trace))
    return runner.run_cell(bench, ctx, T_START, args.seconds)


if __name__ == "__main__":
    sys.exit(main())
