"""Host ms a request of the program's ``data.h2d`` spans (as
h2d_host_ms_per_step.train), over the requests of the traced stretch."""

from benchmark import spans


def read(ctx):
    t = ctx.trace
    if ctx.kind != "serve" or t is None or not t.stretch_units:
        return None
    ms = spans.host_ms(t, "data.h2d")
    return ms / t.stretch_units if ms is not None else None
