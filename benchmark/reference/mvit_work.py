"""The work of an MViTv2 train step, from its shapes: the step's FLOPs,
counted over the plain reference (``benchmark/reference/mvit.py``) at the
cell's shapes by torch's FlopCounterMode (the forward and the backward of
every parameter, no recompute, each convolution's input and weight
gradients counted as its forward, ``work._conv_backward_flops``), and the
least work of the pooled attention, whatever computes it.

``attn_work`` is the attention's floor per block, clip and head: forward
4 Nq Nk d FLOPs (q k^T and the product with v) and 2 (Nq - 1) d (k_t + k_h
+ k_w) for the three relative-position einsums, the backward twice those;
bytes, in bf16, q, k and v read and o written once forward, q, k, v, o
and dO read and dq, dk and dv written once backward, and the three
gathered tables read forward and backward and their gradients written
once. Its least time is the larger of the FLOPs over 989 TFLOP/s and the
bytes over 3.35 TB/s (``work``'s peaks).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import mvit as ref
from .work import BF16_FLOPS_PER_S, HBM_BYTES_PER_S, _conv_backward_flops

ITEMSIZE = 2   # bf16


def step_flops(spec: ref.Spec, clips: int) -> int:
    params = {k: v.requires_grad_(True) for k, v in ref.make_weights(
        ref.param_specs(spec), 0, "meta").items()}
    x = torch.empty((clips, spec.frames, spec.input_size, spec.input_size,
                     3), device="meta")
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})
    with counter:
        logits = ref.forward(params, spec, x, train=False)
        loss = torch.nn.functional.cross_entropy(
            logits, torch.zeros(clips, dtype=torch.long, device="meta"))
        torch.autograd.grad(loss, list(params.values()))
    return int(counter.get_total_flops())


def attn_work(nq: int, nk: int, d: int, k_grid: Tuple[int, int, int],
              q_grid: Tuple[int, int, int]) -> Tuple[int, int]:
    """(FLOPs, bytes) of one block's attention for one clip and head,
    forward and backward; nq and nk count the cls token."""
    fwd = 4 * nq * nk * d + 2 * (nq - 1) * d * sum(k_grid)
    tables = sum(a * b for a, b in zip(q_grid, k_grid)) * d
    nbytes = ((2 * nq + 2 * nk) * d + (4 * nq + 4 * nk) * d
              + 3 * tables) * ITEMSIZE
    return 3 * fwd, nbytes


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def attn_least_ms(spec: ref.Spec, clips: int) -> float:
    """The least time of a step's attention, summed over its blocks,
    heads and clips, in ms."""
    total = 0.0
    for g in ref.geometry(spec):
        d = g.dim_out // g.heads
        flops, nbytes = attn_work(1 + math.prod(g.grid_q),
                                  1 + math.prod(g.grid_kv), d, g.grid_kv,
                                  g.grid_q)
        total += g.heads * clips * least_s(flops, nbytes)
    return total * 1e3
