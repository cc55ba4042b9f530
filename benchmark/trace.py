"""The traced stretch of a run: torch.profiler over a fixed number of
dispatches or requests, and what the metric readers take from it.

Kernel classes are those of ``adamml_tpu_torch/tools/profile_eval_step.py``
(copied, so that a change to the program cannot move the yardstick):
kernel-name fragments, first match wins.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import List, Optional, Tuple

import torch

CLASSES = (
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
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
STRETCH = "bench.stretch"


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, frags in CLASSES:
        if any(f in low for f in frags):
            return cls
    return "other"


class Profiler:
    """torch.profiler over a stretch of the window, in three steps that the
    run takes at unit boundaries (dispatches or requests):

    - ``start()`` drains the device and starts the profiler one unit
      before the stretch, so that the profile holds whole units and the
      drain's idle bubble and the profiler's own start lie outside it;
    - ``open()`` opens the stretch span, without a drain;
    - ``close()`` closes the span, then drains and stops the profiler.

    ``events()`` exports the trace once the window has closed, so that the
    export's host time falls in no measured quantity."""

    def __init__(self):
        self.prof = self.span = None
        self.stopped = False

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def open(self) -> None:
        if self.prof is None or self.span is not None:
            return
        self.span = torch.profiler.record_function(STRETCH)
        self.span.__enter__()

    def close(self) -> None:
        if self.prof is None or self.stopped:
            return
        if self.span is not None:
            self.span.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.stopped = True

    def events(self) -> Optional[List[dict]]:
        """The profile's trace events, or None when the stretch never
        opened (a window too short to reach it)."""
        if self.prof is None:
            return None
        self.close()
        if self.span is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)


class Trace:
    """Device and host events of a profile, in microseconds.

    ``units`` steps or requests ran whole inside the profile (it starts
    and ends on a drained device); the per-unit readings (``device_ms``,
    ``class_ms``, ``launched_in``, ``top_ops``) divide by them. The stretch
    span inside it, ``stretch_units`` of them, starts and ends without a
    drain, so it is a stretch of the steady run: ``busy_s``, ``window_s``
    and ``idle_gaps`` are read over it, device events clipped to it."""

    def __init__(self, events: List[dict], units: int, stretch_units: int):
        xs = [e for e in events if e.get("ph") == "X"]
        spans = [e for e in xs if e.get("name") == STRETCH
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise RuntimeError("the trace holds no stretch span")
        s = spans[0]
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        self.tid = s.get("tid")
        self.units, self.stretch_units = units, stretch_units
        self.all_device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.all_device
                        if e.get("cat") == "kernel"]
        self.device = [e for e in self.all_device if self._overlaps(e)]
        self.host = [e for e in xs if e.get("cat") in HOST_CATS
                     and e.get("tid") == self.tid]
        self.runtime = [e for e in xs if e.get("cat") == "cuda_runtime"]

    def _overlaps(self, e) -> bool:
        ts = float(e["ts"])
        return ts < self.t1 and ts + float(e["dur"]) > self.t0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity, clipped to the stretch."""
        out: List[Tuple[float, float]] = []
        for e in sorted(self.device, key=lambda e: float(e["ts"])):
            a = max(self.t0, float(e["ts"]))
            b = min(self.t1, float(e["ts"]) + float(e["dur"]))
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def device_ms(self, pick) -> float:
        """Device milliseconds of the kernels ``pick(name)`` accepts."""
        return sum(float(e["dur"]) for e in self.kernels
                   if pick(e["name"])) / 1e3

    def class_ms(self, classes) -> float:
        return self.device_ms(lambda n: kernel_class(n) in classes)

    def launched_in(self, span: str) -> float:
        """Device ms of the kernels and copies launched inside the host
        spans named ``span``."""
        wins = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in self.host if e.get("name") == span)
        starts = [a for a, _ in wins]
        corr = set()
        for e in self.runtime:
            if e.get("tid") != self.tid:
                continue
            ts = float(e["ts"])
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= wins[i][1]:
                corr.add(e.get("args", {}).get("correlation"))
        return sum(float(e["dur"]) for e in self.all_device
                   if e.get("args", {}).get("correlation") in corr) / 1e3

    def top_ops(self, k: int = 10) -> List[list]:
        by = defaultdict(float)
        for e in self.kernels:
            by[e["name"][:120]] += float(e["dur"]) / 1e6
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The device's idle time by what the main thread was doing: each
        gap between device intervals goes to the innermost host event that
        covers its middle."""
        ivs = self.intervals()
        edges = [self.t0] + [x for iv in ivs for x in iv] + [self.t1]
        host = sorted(self.host, key=lambda e: float(e["ts"]))
        starts = [float(e["ts"]) for e in host]
        by = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label = "host idle"
            i = bisect.bisect_right(starts, mid) - 1
            for i in range(i, max(-1, i - 4000), -1):
                e = host[i]
                if float(e["ts"]) + float(e["dur"]) >= mid:
                    label = e["name"][:120]
                    break
            by[label] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]
