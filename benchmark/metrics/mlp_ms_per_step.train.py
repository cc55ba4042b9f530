"""Device ms a step of the kernels, copies and fills launched inside the
program's ``model.mlp`` spans (MViT: each block's LN2, fc1, GELU and fc2),
forward and backward, over the traced profile's whole steps
(``benchmark/model_spans.py``). Nothing to read where the program has no
such span."""

from benchmark import model_spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return model_spans.device_ms_per_step(ctx, "model.mlp")
