"""Device ms a step of the elementwise and reduction kernel classes (most
of it train-mode BN), in the traced stretch."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    ms = t.class_ms(("elementwise", "reduction"))
    return ms / t.units if ms else None
