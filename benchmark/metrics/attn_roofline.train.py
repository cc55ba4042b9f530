"""MViT's attention against its roofline: the least time of the
attention's work a step (``benchmark/reference/mvit_work.py::attn_work``
over every block, head and clip: its FLOPs over 989 TFLOP/s or its bytes
over 3.35 TB/s, whichever is larger), over the device time a step of what
the program launches inside its ``model.attn`` spans
(``attn_ms_per_step.train``). The work depends only on the shapes, not on
how the attention is computed. Nothing to read where the program has no
such span or the cell counts no attention."""

from benchmark import model_spans


def read(ctx):
    least = getattr(ctx, "attn_least_ms_per_step", None)
    if ctx.kind != "train" or least is None:
        return None
    ms = model_spans.device_ms_per_step(ctx, "model.attn")
    return 100.0 * least() / ms if ms else None
