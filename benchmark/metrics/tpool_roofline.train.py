"""The fused epilogue kernels' share of their roofline: the least time
their launches could take on the card (benchmark/reference/work.py: each
launch's bytes over 3.35 TB/s or its float32 ops over 67 TFLOP/s,
whichever is larger), over their measured device time, in the traced
stretch. Nothing to read when the trace holds no such launch, or not the
launches a step of this cell makes."""

from benchmark.trace import kernel_class


def share(ctx, backward: bool):
    t = ctx.trace
    if t is None or not t.units:
        return None
    fwd = [e for e in t.kernels if kernel_class(e["name"]) == "fused_epilogue"
           and "bwd" not in e["name"]]
    bwd = [e for e in t.kernels if kernel_class(e["name"]) == "fused_epilogue"
           and "bwd" in e["name"]]
    want = ctx.epilogue
    if (len(fwd) != want["launches_fwd"] * t.units
            or len(bwd) != want["launches_bwd"] * t.units):
        return None
    measured = sum(float(e["dur"]) for e in fwd + bwd) / 1e3
    bound = (want["fwd"] + (want["bwd"] if backward else 0.0)) * t.units
    return 100.0 * bound / measured if measured else None


def read(ctx):
    return share(ctx, backward=True) if ctx.kind == "train" else None
