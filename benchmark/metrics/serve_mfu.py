"""The traced stretch's share of the card's bf16 peak (989 TFLOP/s): the
eval forward's FLOPs, counted over the plain reference at the request's
shapes, times the requests traced, over the stretch."""

from benchmark.reference.work import BF16_FLOPS_PER_S


def read(ctx):
    t = ctx.trace
    if ctx.kind != "serve" or t is None or not t.stretch_units:
        return None
    return (100.0 * ctx.flops_per_request() * t.stretch_units
            / (t.window_s * BF16_FLOPS_PER_S))
