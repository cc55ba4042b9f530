"""Host ms a step of the program's ``step.stage`` span (the copies and
fills that a replay of the train graph reads,
``train/steps.py::_GraphedSteps``), over the spans that start in
the traced stretch."""

from benchmark import spans


def read(ctx):
    t = ctx.trace
    if ctx.kind != "train" or t is None or not t.stretch_units:
        return None
    ms = spans.host_ms(t, "step.stage")
    return ms / t.stretch_units if ms is not None else None
