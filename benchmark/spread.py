"""Runs of one cell, each a process of its own, and their spread.

    python3 benchmark/spread.py --workload <cell> --seeds 1 2 3 4 5 6 \
        [--sets 2] [--trace 0] [--seconds S] [--out runs.jsonl]

runs ``run.py`` once per seed and set (every set over the same seeds),
appends each run's result line (with its seed, set, exit code, wall time
and the end of its standard error) to ``--out``, and prints per set and
metric the median and the spread: the distance between the first and
the third quartile (``statistics.quantiles(values, n=4)``) over the
median, as the bounds of ``BENCHMARK.json`` are set from.  ``--seconds``
defaults to ``run_seconds``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values) -> float:
    if len(values) < 2:
        return float("nan")
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    runs = []
    for s in range(args.sets):
        for seed in args.seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                 "--workload", args.workload, "--seed", str(seed),
                 "--seconds", str(seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            row = {"workload": args.workload, "set": s, "seed": seed,
                   "trace": args.trace, "rc": proc.returncode,
                   "wall_s": time.perf_counter() - t0, "result": result,
                   "stderr": proc.stderr[-3000:]}
            runs.append(row)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            print(json.dumps({k: row[k] for k in ("set", "seed", "rc",
                                                  "wall_s")}
                             | {"correct": result and result["correct"],
                                "metrics": result and {
                                    n: m["value"] for n, m in
                                    result["metrics"].items()},
                                "check": result and {
                                    n: c["value"] for n, c in
                                    result["check"].items()}}),
                  flush=True)
    names = sorted({n for r in runs if r["result"]
                    for n in r["result"]["metrics"]})
    for s in range(args.sets):
        for n in names:
            vals = [r["result"]["metrics"][n]["value"] for r in runs
                    if r["set"] == s and r["result"]
                    and n in r["result"]["metrics"]]
            if vals:
                print(json.dumps({"set": s, "metric": n, "runs": len(vals),
                                  "median": statistics.median(vals),
                                  "spread": spread(vals)}), flush=True)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
