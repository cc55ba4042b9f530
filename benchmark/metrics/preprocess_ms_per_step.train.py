"""Device ms a step of the kernels and copies that the card preprocessing
launches (inside the benchmark's ``bench.preprocess`` span around
``make_batch_preprocessor``'s function), in the traced stretch."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    ms = t.launched_in("bench.preprocess")
    return ms / t.units if ms else None
