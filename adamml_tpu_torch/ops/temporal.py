"""Temporal pooling over the frame axis (``adamml_tpu/ops/temporal.py``).

The reference's only temporal-modeling op (reference models/common.py:4-33):
max/avg pool over time with kernel 3, stride 2, padding 1. Avg mode divides
by the full kernel size including padded positions (count_include_pad).
"""

from __future__ import annotations

import torch


def out_frames(f: int, kernel: int = 3, stride: int = 2) -> int:
    pad = (kernel - 1) // stride
    return (f + 2 * pad - kernel) // stride + 1


def temporal_pool(x: torch.Tensor, kernel: int = 3, stride: int = 2,
                  mode: str = "max") -> torch.Tensor:
    """Pool over axis 1 of (N, F, ..., C). Output frames =
    floor((F + 2*pad - kernel)/stride) + 1 with pad = (kernel-1)//stride.
    Max propagates NaN and, like ``lax.reduce_window``'s VJP, sends each
    window's gradient to its FIRST maximum (``amax`` would split a tie);
    avg sums in float32 and casts back."""
    if mode not in ("max", "avg"):
        raise ValueError("mode must be 'avg' or 'max'")
    pad = (kernel - 1) // stride
    f = x.shape[1]
    outs = []
    for fo in range(out_frames(f, kernel, stride)):
        lo = max(0, fo * stride - pad)
        hi = min(f, fo * stride - pad + kernel)
        win = x[:, lo:hi]
        if mode == "max":
            outs.append(win.max(dim=1).values)
        else:
            outs.append(win.float().sum(dim=1) / float(kernel))
    return torch.stack(outs, dim=1).to(x.dtype)
