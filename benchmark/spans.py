"""What the readers of the program's own spans, counters and capture map
share (``adamml_tpu_torch/utils/profiling.py``).

A program without them (one older than its spans) gives the readers
nothing to read: ``profiling()`` is None, or lacks the table or map asked
for, and the readers return None without raising.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import List, Optional


def profiling():
    """The program's profiling module, or None."""
    try:
        from adamml_tpu_torch.utils import profiling as mod
    except ImportError:
        return None
    return mod


def capture_map() -> Optional[dict]:
    """The newest capture map of the program's registry (``CAPTURES``): the
    graph the run replays, captured once in its set-up."""
    maps = getattr(profiling(), "CAPTURES", None)
    return maps[-1] if maps else None


def counter(name: str) -> Optional[dict]:
    """The program's counter ``name``: {count, seconds}, or None."""
    counters = getattr(profiling(), "counters", None)
    return counters().get(name) if counters is not None else None


def replays(trace) -> List[List[dict]]:
    """The kernel events of each graph replay in the trace: grouped by the
    correlation of the ``cudaGraphLaunch`` that ran them, each group and
    the groups in order of start."""
    launches = {e.get("args", {}).get("correlation") for e in trace.runtime
                if "GraphLaunch" in e.get("name", "")}
    groups = defaultdict(list)
    for e in trace.kernels:
        c = e.get("args", {}).get("correlation")
        if c in launches:
            groups[c].append(e)
    out = [sorted(g, key=lambda e: float(e["ts"])) for g in groups.values()]
    return sorted(out, key=lambda g: float(g[0]["ts"]))


def _match(group: List[dict], cmap: dict, names: bool) -> Optional[list]:
    """(event, label) for each kernel node of the map, taken from one
    replay's kernels in order. The driver may run memcpy and memset nodes
    of a replayed graph as kernels of its own (``memcpy...``,
    ``memset...``): up to as many such kernels as the map has such nodes
    are passed over where they do not match the next kernel node. None
    when the replay holds other kernels, or (``names``) another name."""
    want = cmap["names"] or [None] * len(cmap["labels"])
    spare = Counter(cmap.get("driver_nodes", {}))
    out = []
    for e in group:
        i, name = len(out), e["name"]
        if i == len(want) or want[i] != name:
            kind = next((k for k in spare if name.startswith(k)), None)
            if kind is not None and spare[kind] > 0:
                spare[kind] -= 1
                continue
            if i == len(want) or (names and want[i] is not None):
                return None
        out.append((e, cmap["labels"][i]))
    return out if len(out) == len(want) else None


def labelled_replays(trace, names: bool = True) -> Optional[List[list]]:
    """Each replay's kernels with the capture map's labels, (event, label)
    in the order of the graph's kernel nodes; None when the trace holds no
    replay or the program no map, or when any replay's kernels do not
    match the map's nodes one to one (count, or with ``names`` a name)."""
    cmap = capture_map()
    groups = replays(trace) if trace is not None else []
    if cmap is None or not groups:
        return None
    out = [_match(g, cmap, names) for g in groups]
    return None if any(m is None for m in out) else out


def host_ms(trace, name: str) -> Optional[float]:
    """Host ms of the main thread's spans ``name`` that start inside the
    traced stretch, or None when there is none."""
    if trace is None:
        return None
    durs = [float(e["dur"]) for e in trace.host if e.get("name") == name
            and trace.t0 <= float(e["ts"]) < trace.t1]
    return sum(durs) / 1e3 if durs else None
