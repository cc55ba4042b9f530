"""Host ms a step of the program's ``data.h2d`` spans (the pinned copy of
each host array and the enqueue of its copy to the card,
``data/device_pipeline.py::to_device``), over the spans that start in the
traced stretch."""

from benchmark import spans


def read(ctx):
    t = ctx.trace
    if ctx.kind != "train" or t is None or not t.stretch_units:
        return None
    ms = spans.host_ms(t, "data.h2d")
    return ms / t.stretch_units if ms is not None else None
