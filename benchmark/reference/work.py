"""The work a step must do, from its shapes: the fused epilogue kernels'
bytes and operations, their least time on the card, and the FLOPs of a
whole step counted over the plain reference.

H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): 3.35 TB/s
of HBM3, 989 TFLOP/s in bfloat16, 67 TFLOP/s in float32 outside the
tensor cores.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import model as ref

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
EPILOGUE_STAGES = 3   # after ResNet stages 1-3


def tpool_work(n, f, h, w, c, itemsize):
    """(bytes, float32 ops) the fused epilogue's forward must move and do:
    read y and ident, write the pooled output; 4 ops an input element (mul,
    2 adds, relu) and the window maxima."""
    fo = (f - 1) // 2 + 1
    bytes_ = (2 * n * f + n * fo) * h * w * c * itemsize
    window_cmp = sum(min(f, 2 * k + 2) - max(0, 2 * k - 1) - 1
                     for k in range(fo))
    ops = (4 * n * f + window_cmp * n) * h * w * c
    return bytes_, ops


def tpool_bwd_work(n, f, h, w, c, itemsize):
    """(bytes, float32 ops) of its backward: read y, ident and the pooled
    cotangent, write dident and dy; about 14 ops an input element."""
    fo = (f - 1) // 2 + 1
    bytes_ = (4 * n * f + n * fo) * h * w * c * itemsize
    return bytes_, 14 * n * f * h * w * c


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def epilogue_shapes(rows: int, frames: int, input_size: int
                    ) -> List[Tuple[int, int, int, int, int]]:
    """(N, F, H, W, C) at the three ResNet-50 stage boundaries that pool
    over time, for ``rows`` clip-segments of ``frames`` frames."""
    out, f, side = [], frames, input_size // 4
    for stage in range(EPILOGUE_STAGES):
        if f <= 1:
            break
        out.append((rows, f, side, side, 256 * 2 ** stage))
        f, side = (f - 1) // 2 + 1, side // 2
    return out


def epilogue_bound_ms(spec: ref.Spec, rows: int, backward: bool,
                      itemsize: int = 2) -> Dict[str, float]:
    """Least ms of one step's epilogue launches: {"fwd": sum, "bwd": sum,
    "launches_fwd": n, "launches_bwd": n} over every ResNet of the main
    net."""
    shapes = epilogue_shapes(rows, spec.frames, spec.input_size)
    nets = sum(1 for m in spec.main_modality if m != "sound")
    fwd = sum(bound_ms(*tpool_work(*s, itemsize)) for s in shapes) * nets
    bwd = (sum(bound_ms(*tpool_bwd_work(*s, itemsize)) for s in shapes)
           * nets if backward else 0.0)
    return {"fwd": fwd, "bwd": bwd, "launches_fwd": len(shapes) * nets,
            "launches_bwd": len(shapes) * nets if backward else 0}


def _meta_inputs(spec: ref.Spec, clips: int, segments: int):
    size, out = spec.input_size, {}
    frames = round(spec.resampling_rate * spec.audio_length)
    for m in spec.modality:
        if m == "sound":
            shape = (clips, segments, 1, 256, 1 + (frames - 1) // round(
                0.005 * spec.resampling_rate), 1)
        else:
            shape = (clips, segments, spec.frames, size, size,
                     ref.CHANNELS[m])
        out[m] = torch.empty(shape, device="meta")
    return out


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, bias, stride,
                         padding, dilation, transposed, output_padding,
                         groups, output_mask, out_shape=None) -> int:
    """Each of a convolution's input and weight gradients costs what its
    forward costs: 2 x batch x |w| x output pixels, |w| holding the group
    split. (torch's own formula counts a grouped convolution's input
    gradient as if it were dense: 20x a MobileNetV2's forward.)"""
    fwd = 2 * grad_out_shape[0] * math.prod(w_shape) * math.prod(
        (grad_out_shape if not transposed else x_shape)[2:])
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def step_flops(spec: ref.Spec, kind: str, clips: int, segments: int) -> int:
    """FLOPs of one step over the reference at these shapes, by torch's
    FlopCounterMode: kind "eval" the forward; "main" / "policy" the
    forward of both subnets and the backward of the live one, with no
    recompute."""
    weights = ref.make_weights(ref.param_specs(spec), 0, "meta")
    params = {k: v for k, v in weights.items() if not ref.is_statistic(k)}
    stats = {k: v for k, v in weights.items() if ref.is_statistic(k)}
    inputs = _meta_inputs(spec, clips, segments)
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})
    with counter:
        if kind == "eval":
            with torch.no_grad():
                ref.forward(params, stats, spec, inputs, train=False,
                            gumbel=None)
        else:
            live = [k for k in params if k.startswith(f"{kind}_net.")]
            for k in live:
                params[k].requires_grad_(True)
            logits, decisions, _ = ref.forward(
                params, stats, spec, inputs, train=True, gumbel=None,
                live=kind)
            loss = torch.nn.functional.cross_entropy(
                logits, torch.zeros(clips, dtype=torch.long, device="meta"))
            if kind == "policy":
                loss = loss + ref.blockdrop_loss(
                    decisions, logits, torch.zeros(clips, device="meta"),
                    spec.cost_weights, spec.gammas)
            torch.autograd.grad(loss, [params[k] for k in live])
    return int(counter.get_total_flops())
