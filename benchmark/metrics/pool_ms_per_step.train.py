"""Device ms a step of the kernels, copies and fills launched inside the
program's ``model.pool`` spans (MViT: each block's three depthwise pooling
convolutions with their LayerNorms, the cls token's split and join),
forward and backward, over the traced profile's whole steps
(``benchmark/model_spans.py``). Nothing to read where the program has no
such span."""

from benchmark import model_spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return model_spans.device_ms_per_step(ctx, "model.pool")
