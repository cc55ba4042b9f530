"""Device ms a step of the kernels, copies and fills launched inside the
program's ``model.bn`` spans (train-mode BN's six kernels, forward and
backward, ``models/norm.py``) in an eager step, over the traced profile's
whole steps (``benchmark/model_spans.py``); ``bn_ms_per_step.train`` is
its counterpart for the replayed graph of the AdaMML cells. Nothing to
read where the entry keeps no raw events or the program has no such
span."""

from benchmark import model_spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return model_spans.device_ms_per_step(ctx, "model.bn")
