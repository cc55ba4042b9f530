#!/usr/bin/env python3
"""Where the flagship step's time goes on the card (the port's counterpart
of tools/profile_step.py).

    python -m adamml_tpu_torch.tools.profile_eval_step
        [--phase eval|main|policy] [--batch 8] [--steps 3] [--trace PATH]
        [--use_pallas_dw]

Builds the flagship AdaMML (bf16, seeded random weights), runs two warm-up
steps of the phase (the eval step, or the train step's main or policy
phase), then profiles ``--steps`` steps with torch.profiler (CPU and CUDA).
``--use_pallas_dw`` runs every 3x3 depthwise layer through the hand-written
depthwise kernel.
Prints JSON lines: the step's host-clock latency and the peak device memory
of the profiled steps; the device's busy time (union of kernel intervals)
and idle share; device time by kernel class (convolution, matmul,
elementwise, reduction, the fused epilogue kernels, the depthwise kernel,
other); and the top
kernels by device time. ``--trace`` keeps the Chrome trace. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch

from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models.model_builder import build_model, example_inputs
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.steps import (make_adamml_eval_step,
                                          make_adamml_train_step)
from adamml_tpu_torch.train.train_state import (EvalState, StageFlags,
                                                TrainState)

# kernel-name fragments -> class, first match wins
_CLASSES = (
    ("fused_epilogue", ("tpool_fused",)),
    ("depthwise_kernel", ("dw3x3_kernel",)),
    ("convolution", ("conv_depthwise", "fprop", "implicit_convolve",
                     "conv2d_", "nchwtonhwc", "nhwctonchw", "addpadding",
                     "winograd")),
    ("elementwise", ("elementwise_kernel", "copy_kernel", "fill_kernel",
                     "catarray", "index", "upsample", "max_pool",
                     "avg_pool")),
    ("reduction", ("reduce_kernel", "softmax", "topk", "sort")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, frags in _CLASSES:
        if any(f in low for f in frags):
            return cls
    return "other"


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phase", choices=("eval", "main", "policy"),
                   default="eval")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--trace", default="")
    p.add_argument("--use_pallas_dw", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_eval_step: no CUDA device", file=sys.stderr)
        return 1

    cfg = flagship_cfg()
    cfg.model.use_pallas_dw = args.use_pallas_dw
    model, name = build_model(cfg)
    inputs = example_inputs(cfg, batch=args.batch, seed=0)
    target = torch.zeros(args.batch, dtype=torch.long, device="cuda")
    if args.phase == "eval":
        eval_step = make_adamml_eval_step(model)

        def step(i):
            eval_step(EvalState(), inputs, target, i)
    else:
        # the train step's settings of bench.py:156-161
        state = TrainState(
            build_optimizer("main", cfg.optim, model.main_net.parameters()),
            build_optimizer("policy", cfg.optim,
                            model.policy_net.parameters()))
        train_step = make_adamml_train_step(
            model, flags=(StageFlags.main_phase() if args.phase == "main"
                          else StageFlags.policy_phase()),
            penalty_type="blockdrop", gammas=10.0, clip_gradient=None)

        def step(i):
            train_step(state, inputs, target, 1e-3, 1e-2, [1.0, 0.05], i)
    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    lat = []
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.steps):
            with torch.profiler.record_function("step"):
                t0 = time.perf_counter()
                step(i)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]

    # the CPU-side annotation only: record_function also emits a GPU-lane
    # copy of the same span
    steps = [e for e in events if e.get("ph") == "X"
             and e.get("name") == "step"
             and e.get("cat") == "user_annotation"]
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"]
    wall = sum(float(e["dur"]) for e in steps)
    busy = _union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in kernels])
    by_class, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        d = float(e["dur"])
        by_class[kernel_class(e["name"])] += d
        by_name[e["name"]][0] += d
        by_name[e["name"]][1] += 1
    dev_total = sum(by_class.values())
    n = args.steps
    card = torch.cuda.get_device_name(0)
    print(json.dumps({
        "phase": "profile", "step": args.phase, "arch": name, "card": card,
        "use_pallas_dw": args.use_pallas_dw,
        "batch_clips": args.batch, "steps": n,
        "latency_ms": [x * 1e3 for x in lat],
        "max_memory_allocated_bytes": peak,
        "device_busy_ms_per_step": busy / 1e3 / n,
        "device_idle_share": 1.0 - busy / wall if wall else None,
        "kernel_launches_per_step": len(kernels) / n,
        "device_ms_per_step_by_class": {
            k: v / 1e3 / n for k, v in sorted(by_class.items(),
                                              key=lambda kv: -kv[1])},
        "share_of_device_time_by_class": {
            k: v / dev_total for k, v in by_class.items()}}), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    for kname, (d, cnt) in top:
        print(json.dumps({"phase": "top_kernel", "ms_per_step": d / 1e3 / n,
                          "launches_per_step": cnt / n,
                          "class": kernel_class(kname),
                          "name": kname[:160]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
