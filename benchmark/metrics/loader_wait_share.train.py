"""Share of the window the epoch loop waited for the host loader: the
loop's own data time (``train/engine.py::train_epoch``'s ``data_time``,
per batch) times the steps, less the host time of the benchmark's own
profiler calls that the loop counts in it, over the window less that
time."""


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    return 100.0 * ctx.data_wait_s / ctx.window_s
