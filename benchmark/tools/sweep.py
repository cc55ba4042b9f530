#!/usr/bin/env python3
"""Runs of one cell, one process each, one after another, and the spread
of each metric: ``statistics.quantiles(values, n=4)``'s first and third
quartiles' distance over the median.

    python3 benchmark/tools/sweep.py --workload <cell> --seconds 30
        --seeds 11 12 13 [--trace 0|1] [--out FILE]

Prints each run's result line (prefixed ``run``, with every number the
run compared or printed beside them), the compared numbers' largest
readings and a ``spread`` line; ``--out`` appends the records to FILE.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("nan")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    values, compared, bad = {}, {}, 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", args.workload,
             "--seed", str(seed), "--seconds", str(args.seconds), "--trace",
             str(args.trace)], cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            line = None
        rec = {"seed": seed, "rc": proc.returncode, "wall_s": wall,
               "line": line, "numbers": [
                   ln for ln in proc.stderr.splitlines()
                   if ln.startswith(("numbers ", "worst ", "losses ",
                                     "host "))]}
        if line is None or proc.returncode:
            bad += 1
            rec["stderr_tail"] = proc.stderr[-3000:]
        print("run " + json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps({"workload": args.workload, **rec}) + "\n")
        if line is None:
            continue
        for name, m in line["metrics"].items():
            values.setdefault(name, []).append(m["value"])
        for name, (v, lim) in line["compared"].items():
            compared.setdefault(name, []).append(v)
    print("compared_max " + json.dumps({k: max(v) for k, v in
                                        compared.items()}))
    print("spread " + json.dumps(
        {k: {"median": statistics.median(v), "spread": spread(v),
             "n": len(v)} for k, v in values.items() if len(v) >= 2}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
