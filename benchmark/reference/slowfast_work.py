"""The FLOPs of a SlowFast train step, counted over the plain reference
(``benchmark/reference/slowfast.py``) at the cell's shapes by torch's
FlopCounterMode: the forward and the backward of every parameter, with
no recompute, each convolution's input and weight gradients counted as
its forward (``work._conv_backward_flops``)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import slowfast as ref
from .work import _conv_backward_flops


def step_flops(spec: ref.Spec, clips: int) -> int:
    weights = ref.make_weights(ref.param_specs(spec), 0, "meta")
    params = {k: v.requires_grad_(True) for k, v in weights.items()
              if not ref.is_statistic(k)}
    stats = {k: v for k, v in weights.items() if ref.is_statistic(k)}
    x = torch.empty((clips, spec.frames, spec.input_size, spec.input_size,
                     3), device="meta")
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})
    with counter:
        logits, _ = ref.forward(params, stats, spec, x, train=True)
        loss = torch.nn.functional.cross_entropy(
            logits, torch.zeros(clips, dtype=torch.long, device="meta"))
        torch.autograd.grad(loss, list(params.values()))
    return int(counter.get_total_flops())
