#!/usr/bin/env python3
"""One benchmark run with the device time launched inside a host span of
its traced run taken apart, and the allocator's peaks.

    python3 trace_split.py [--root DIR] [--span NAME] -- \\
        --workload rgbflow.train-main --seed 1 --seconds 51 --trace 1

Runs ``DIR/benchmark/run.py`` (DIR: this script's directory by default,
so the checkout of a parent commit can be read with the same script) with
the arguments after ``--``, printing its own output, and on standard
error:

  split {...}     for the span NAME (default ``bench.preprocess``), the
                  device ms a unit (step or request) of the kernels,
                  copies and memsets launched inside it, by category
                  (``benchmark/trace.py::Trace.launched_in`` over each
                  category's events alone, so the categories sum to what
                  ``preprocess_ms_per_step.train`` reads) and the eight
                  largest by name;
  memstats {...}  at each read of ``torch.cuda.max_memory_allocated``
                  (``peak_mem_gib``), the allocator's allocated, requested
                  and reserved peaks.
"""

from __future__ import annotations

import bisect
import json
import os
import runpy
import sys
from collections import defaultdict
from pathlib import Path


def split(trace, span: str) -> dict:
    every = trace.all_device
    by_cat = {}
    try:
        for cat in sorted({e.get("cat") for e in every}):
            trace.all_device = [e for e in every if e.get("cat") == cat]
            by_cat[cat] = trace.launched_in(span) / trace.units
    finally:
        trace.all_device = every
    # the correlations of the launches inside the span, as launched_in
    wins = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in trace.host if e.get("name") == span)
    starts = [a for a, _ in wins]
    corr = set()
    for e in trace.runtime:
        i = bisect.bisect_right(starts, float(e["ts"])) - 1
        if (e.get("tid") == trace.tid and i >= 0
                and float(e["ts"]) <= wins[i][1]):
            corr.add(e.get("args", {}).get("correlation"))
    by_name = defaultdict(float)
    for e in every:
        if e.get("args", {}).get("correlation") in corr:
            by_name[e["name"][:90]] += float(e["dur"]) / 1e3 / trace.units
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"span": span, "units": trace.units, "ms_per_unit_by_cat": by_cat,
            "top_ms_per_unit": top}


def main() -> None:
    argv = sys.argv[1:]
    cut = argv.index("--") if "--" in argv else len(argv)
    opts, rest = argv[:cut], argv[cut + 1:]
    root = Path(__file__).resolve().parent
    span = "bench.preprocess"
    for flag, value in zip(opts[::2], opts[1::2]):
        if flag == "--root":
            root = Path(value).resolve()
        elif flag == "--span":
            span = value
        else:
            raise SystemExit(f"trace_split: unknown option {flag}")
    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch
    from benchmark import trace as bt

    init, peak = bt.Trace.__init__, torch.cuda.max_memory_allocated

    def traced(self, *args, **kwargs):
        init(self, *args, **kwargs)
        print("split " + json.dumps(split(self, span)), file=sys.stderr,
              flush=True)

    def peaks(device=None):
        value = peak(device)
        st = torch.cuda.memory_stats(device)
        print("memstats " + json.dumps({
            "max_memory_allocated": value,
            "allocated_peak": st.get("allocated_bytes.all.peak"),
            "requested_peak": st.get("requested_bytes.all.peak"),
            "reserved_peak": st.get("reserved_bytes.all.peak")}),
            file=sys.stderr, flush=True)
        return value

    bt.Trace.__init__ = traced
    torch.cuda.max_memory_allocated = peaks
    sys.argv = ["benchmark/run.py"] + rest
    runpy.run_path("benchmark/run.py", run_name="__main__")


if __name__ == "__main__":
    main()
