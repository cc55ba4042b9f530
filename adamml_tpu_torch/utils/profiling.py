"""Step profiling (``adamml_tpu/utils/profiling.py``) on ``torch.profiler``.

With --profile_dir set, the curriculum hands the engine a ``StepProfiler``
for the first epoch of each training pass; steps [start, start + count) of
it (loader indices) are traced, the host's and, when a card is present,
the card's activity, and written to the directory as a Chrome trace
(``*.pt.trace.json``, readable by Perfetto or chrome://tracing).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch


class StepProfiler:
    def __init__(self, trace_dir: Optional[str], start_step: int = 2,
                 num_steps: int = 3) -> None:
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.path: Optional[str] = None  # the trace, once written
        self._prof = None
        self._done = False

    def step(self, global_step: int) -> None:
        """Call once per step with the running step index."""
        if not self.trace_dir or self._done:
            return
        if self._prof is None and global_step == self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and global_step >= self.stop_step:
            self._stop()

    def close(self) -> None:
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the traced steps' kernels finish
        self._prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self.path = os.path.join(
            self.trace_dir, f"steps_{self.start_step}-{self.stop_step}_"
                            f"{time.time_ns()}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self._done = True
