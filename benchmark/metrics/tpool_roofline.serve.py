"""The fused epilogue's forward kernel's share of its roofline in the
eval step (as tpool_roofline.train)."""

from benchmark.harness import reader


def read(ctx):
    if ctx.kind != "serve":
        return None
    return reader("tpool_roofline.train").share(ctx, backward=False)
