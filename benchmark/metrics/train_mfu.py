"""The traced stretch's share of the card's bf16 peak (989 TFLOP/s): the
FLOPs of the phase's step, counted over the plain reference at the cell's
shapes, times the steps traced, over the stretch."""

from benchmark.reference.work import BF16_FLOPS_PER_S


def read(ctx):
    t = ctx.trace
    if ctx.kind != "train" or t is None or not t.stretch_units:
        return None
    return (100.0 * ctx.flops_per_step() * t.stretch_units
            / (t.window_s * BF16_FLOPS_PER_S))
