"""The 95th percentile of the window's request latencies, from hand-in to
logits and decisions on the host, in ms, over the requests that ran
while the profiler was off. The host's speed moves it from run to run by
more than an end-to-end bound may allow (PERF.md, section 2)."""

import numpy as np


def read(ctx):
    if ctx.kind != "serve" or not ctx.latency_s:
        return None
    return float(np.percentile(ctx.latency_s, 95)) * 1e3
