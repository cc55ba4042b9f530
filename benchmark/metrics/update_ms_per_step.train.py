"""Device ms a step of the optimizers' multi-tensor kernels (the update
and its norms), in the traced stretch."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    ms = t.device_ms(lambda n: "multi_tensor_apply" in n)
    return ms / t.units if ms else None
