"""Share of the traced stretch in which no kernel, copy or memset ran."""


def read(ctx):
    t = ctx.trace
    if ctx.kind != "train" or t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
