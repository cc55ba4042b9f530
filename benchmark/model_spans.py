"""Device time under the program's model spans on any thread
(``adamml_tpu_torch/utils/profiling.py::spanned``): in an eager step the
forward's spans lie on the main thread and the backward's on the thread
that runs it (the autograd engine's, for a card), so a span's kernels are
those whose launch (a ``cuda_runtime`` event) lies inside one of its
ranges on the same thread, matched to the device's events by their
correlation.

A run whose entry keeps no raw events (``ctx.events``), or whose program
has no such span (one older than the span), reads nothing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Optional


def device_ms_per_step(ctx, span: str) -> Optional[float]:
    """Device ms a step of the kernels, copies and fills launched inside
    the ranges named ``span``, over the profile's whole steps."""
    t, events = ctx.trace, getattr(ctx, "events", None)
    if t is None or not t.units or not events:
        return None
    wins = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("name") == span
                and e.get("cat") == "user_annotation"):
            ts = float(e["ts"])
            wins[e.get("tid")].append((ts, ts + float(e["dur"])))
    if not wins:
        return None
    for w in wins.values():
        w.sort()
    starts = {tid: [a for a, _ in w] for tid, w in wins.items()}
    corr = set()
    for e in t.runtime:
        tid = e.get("tid")
        if tid not in wins:
            continue
        ts = float(e["ts"])
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and ts <= wins[tid][i][1]:
            corr.add(e.get("args", {}).get("correlation"))
    corr.discard(None)
    ms = sum(float(e["dur"]) for e in t.all_device
             if e.get("args", {}).get("correlation") in corr) / 1e3
    return ms / t.units
