"""Timing and accuracy helpers for the port's measurements on the card
(``chip_smoke.py``'s kernel timings and the kernel tools).

Peaks are the H100 SXM data sheet's: the bound of a kernel is the larger of
its bytes over the memory rate and its operations over the peak rate for
their type (float32 outside the tensor cores here).
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# zeroed between timed runs: larger than the 50 MB L2, so every run reads
# its inputs from device memory
L2_FLUSH_BYTES = 256 << 20
# marker kernels before and after a profiled call (device_trace)
MARKERS = 32


def need_card() -> None:
    """Raise unless a CUDA card is present: a measurement never falls back
    to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this measurement runs on the card")


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def l2_flush_buffer(dev) -> torch.Tensor:
    return torch.empty(L2_FLUSH_BYTES // 4, device=dev)


def event_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` runs after ``warmup``;
    ``flush`` (a buffer zeroed between runs, outside the timed span) evicts
    the L2 cache so every run reads its inputs from device memory. A spin
    of about 60 ms queued first keeps the card busy while the host queues
    every run, so no host gap between the events is counted as device
    time."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)
    for start, end in pairs:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound_ms(nbytes: float, f32_ops: float):
    """(least time in ms, "bytes" or "operations") for the work."""
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, f32_ops / F32_OPS_PER_S
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s
                                       else "operations")


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``t`` (0 at 0)."""
    w = t.float()
    _, e = torch.frexp(w)
    return torch.where(w == 0, torch.zeros_like(w),
                       torch.ldexp(torch.ones_like(w), e - 8))


def within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> bool:
    return bool(((got.float() - want.float()).abs() <= bf16_ulp(want)).all())


def device_trace(fn) -> tuple:
    """(kernel events, wall us) of one call of ``fn``, ending in
    torch.cuda.synchronize(): the "kernel" events of a torch.profiler
    trace (CPU and CUDA activities) as (name, start us, duration us), and
    the host's span of the call, counted as
    adamml_tpu_torch/tools/profile_eval_step.py counts them. A later
    session in a process can miss its first kernels (and a trace its
    last), so runs of marker kernels (torch.cuda._sleep's spin_kernel)
    come before and after the call; the trace must begin and end with a
    marker, and the call's kernels are the others."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        torch.cuda._sleep(10_000_000)
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with torch.profiler.record_function("profiled_call"):
            fn()
            torch.cuda.synchronize()
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted(((e["name"], float(e["ts"]), float(e["dur"]))
                      for e in events if e.get("ph") == "X"
                      and e.get("cat") == "kernel"), key=lambda k: k[1])
    wall = sum(float(e["dur"]) for e in events if e.get("ph") == "X"
               and e.get("name") == "profiled_call"
               and e.get("cat") == "user_annotation")
    marks = ["spin_kernel" in k[0] for k in kernels]
    if not (marks and marks[0] and marks[-1]):
        raise RuntimeError(f"check failed: the profiler trace lost the "
                           f"markers around the profiled call "
                           f"({len(kernels)} kernels)")
    return [k for k, m in zip(kernels, marks) if not m], wall
