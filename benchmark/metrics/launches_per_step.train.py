"""Kernel launches a step of the replayed train graph: its kernel nodes
over the K steps it holds, from the program's capture map. Nothing to read
when a replay in the trace runs another count of kernels."""

from benchmark import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    if spans.labelled_replays(ctx.trace, names=False) is None:
        return None
    cmap = spans.capture_map()
    return cmap["kernels"] / cmap["k"]
