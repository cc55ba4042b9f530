"""Host ms a step of the program's ``step.replay`` span
(``CUDAGraph.replay()`` alone, ``train/steps.py::_GraphedSteps``), over
the spans that start in the traced stretch."""

from benchmark import spans


def read(ctx):
    t = ctx.trace
    if ctx.kind != "train" or t is None or not t.stretch_units:
        return None
    ms = spans.host_ms(t, "step.replay")
    return ms / t.stretch_units if ms is not None else None
