"""Spreads of result lines, for setting and checking bounds.

    python3 perfbench/spread.py results.jsonl [more.jsonl ...]

Each file holds result lines (one JSON object a line, as `run.py` prints
them) of one set of runs of one cell.  For each file and metric it prints
the median and the spread: the distance between the first and third
quartiles (`statistics.quantiles(values, n=4)`) as a share of the median.
"""
import json
import statistics
import sys


def spreads(lines):
    values = {}
    for line in lines:
        result = json.loads(line)
        for name, m in result["metrics"].items():
            values.setdefault(name, []).append(m["value"])
    out = {}
    for name, vs in values.items():
        med = statistics.median(vs)
        q = statistics.quantiles(vs, n=4) if len(vs) > 1 else [med, med, med]
        out[name] = (len(vs), med, (q[2] - q[0]) / med if med else 0.0)
    return out


def main(paths) -> int:
    for path in paths:
        with open(path) as f:
            lines = [ln for ln in f if ln.strip().startswith("{")]
        for name, (n, med, spread) in sorted(spreads(lines).items()):
            print(f"{path}\t{name}\tn={n}\tmedian={med!r}\tspread={spread:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
