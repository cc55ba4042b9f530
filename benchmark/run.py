#!/usr/bin/env python3
"""The benchmark of adamml_tpu_torch, one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout. Needs as many CUDA cards as the cell asks
for; without them it exits non-zero and prints no result. It makes its
inputs and weights from --seed, sets up and warms up the cell (counted as
``setup_s``), measures for --seconds, then checks what the timed path
produced against the plain reference in ``benchmark/reference``. The last
lines of standard error give each compared number beside its limit; the
last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics from a profiled stretch of the window), device, with
--trace 1 a breakdown, and last the compared numbers with their limits.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.entry(cell.traffic["entry"]).run(
        cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda"), T_START)
    line = harness.result_line(cell, out, trace=bool(args.trace),
                               kind=torch.cuda.get_device_name(0),
                               count=cell.chips)
    found = harness.banned_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in out.compared.items():
        print(f"compared {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
