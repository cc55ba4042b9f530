#!/usr/bin/env python3
"""The hand-written depthwise kernel (ops/kernels/depthwise.py) against
cuDNN's depthwise convolution on the card, with a numeric check: the port's
counterpart of tools/bench_depthwise.py.

    python -m adamml_tpu_torch.tools.bench_depthwise

At that tool's four shapes (B, H, W, C) = (80, 80, 80, 96),
(80, 40, 40, 144), (80, 20, 20, 384) and (80, 10, 10, 960), in bf16 at
stride 1 with ReLU6 and the identity affine given as float32 ones and
zeros, it times one ``depthwise_conv3x3`` call and the cuDNN composition
(``F.conv2d(..., padding=1, groups=C)`` on the channels_last view, then the
clip: two kernels) with CUDA events around each call, the L2 flushed between
runs. The call's time is one kernel's: the wrapper launches nothing else
(its float32 scale and bias and its bf16 taps are read as they are). It
prints one JSON line per shape: ms, GB/s (x read once, out written once,
the bf16 taps, as that tool counts them), cuDNN's time over the kernel's,
and the largest difference between the two results. Needs a CUDA card; it
raises without one.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from adamml_tpu_torch.ops.kernels import depthwise as dwk
from adamml_tpu_torch.tools.timing import (bf16_ulp, event_ms,
                                           l2_flush_buffer, need_card,
                                           nvidia_smi)

SHAPES = [(80, 80, 80, 96), (80, 40, 40, 144), (80, 20, 20, 384),
          (80, 10, 10, 960)]
# one bf16 rounding apart, plus float32 summation-order noise of results
# near 0 (nine products of N(0, 1) values sum to |x| of a few units)
ATOL = 1e-3


def run(dev) -> list:
    """One dict per shape; raises if the kernel and cuDNN disagree beyond
    one bf16 ulp plus ``ATOL``."""
    flush = l2_flush_buffer(dev)
    rows = []
    for b, h, w, c in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((b, h, w, c), generator=gen,
                        device=dev).to(torch.bfloat16)
        k = torch.randn((3, 3, c), generator=gen,
                        device=dev).to(torch.bfloat16)
        kc = k.permute(2, 0, 1)[:, None].contiguous()  # (C, 1, 3, 3)
        ones = torch.ones(c, device=dev)
        zeros = torch.zeros(c, device=dev)

        def kernel():
            return dwk.depthwise_conv3x3(x, k, stride=1, scale=ones,
                                         bias=zeros, relu6=True)

        def cudnn():
            return torch.clamp(F.conv2d(x.permute(0, 3, 1, 2), kc, padding=1,
                                        groups=c), 0.0, 6.0)

        with torch.no_grad():
            got = kernel()
            want = cudnn().permute(0, 2, 3, 1)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            ok = bool((diff <= bf16_ulp(want) + ATOL).all())
            k_ms = event_ms(kernel, flush=flush)
            c_ms = event_ms(cudnn, flush=flush)
        nbytes = 2 * x.numel() * 2 + k.numel() * 2
        rows.append(dict(shape=[b, h, w, c], kernel_ms=k_ms, cudnn_ms=c_ms,
                         kernel_GBps=nbytes / k_ms / 1e6,
                         cudnn_GBps=nbytes / c_ms / 1e6,
                         cudnn_over_kernel=c_ms / k_ms,
                         max_abs_err=float(diff.max()),
                         within_tolerance=ok))
        if not ok:
            raise RuntimeError(f"depthwise kernel and cuDNN differ by "
                               f"{float(diff.max())} at {(b, h, w, c)}, "
                               f"beyond 1 bf16 ulp + {ATOL}")
    return rows


def main() -> int:
    need_card()
    dev = torch.device("cuda", 0)
    print(json.dumps({"card": nvidia_smi()}), flush=True)
    for row in run(dev):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
