#!/usr/bin/env python3
"""Stage-boundary ``bn-apply + residual-add + relu + temporal max-pool``
formulations on the card: the port's counterpart of tools/bench_tpool.py.

    python -m adamml_tpu_torch.tools.bench_tpool [batch=8]

Rows, each at the flagship's three stage-boundary shapes
(batch x 5 segments rows; (8, 56, 56, 256), (4, 28, 28, 512),
(2, 14, 14, 1024)), bf16, a = 0.9 and b = 0.1 per channel:

  tpool_rw     the eager composition with a reduce-window pool
               (``F.max_pool3d`` over frames, lax.reduce_window's
               counterpart);
  tpool_slice  the composition with the pool as a max over frame slices
               (``tpool_proto.reference_impl``, the plain version);
  kernel       the hand-written prototype kernel
               (``tpool_proto.tpool_proto``, csrc/tpool_proto.cu).

Each prints one JSON line: CUDA-event ms with the L2 flushed between runs,
GB/s (y and ident read once, out written once; the JAX tool's count leaves
out ident), whether the result equals tpool_rw's, and whether it is within
one bf16 ulp of the plain version's. Needs a CUDA card; it raises without
one.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from adamml_tpu_torch.ops.kernels import tpool_proto as tpp
from adamml_tpu_torch.tools.timing import (event_ms, l2_flush_buffer,
                                           need_card, nvidia_smi,
                                           within_one_bf16_ulp)


def tpool_rw(y, ident, a, b):
    z = tpp.affine_relu_add(y, ident, a, b)
    pooled = F.max_pool3d(z.permute(0, 4, 1, 2, 3), (3, 1, 1), (2, 1, 1),
                          (1, 0, 0))
    return pooled.permute(0, 2, 3, 4, 1)


ROWS = (("tpool_rw", tpool_rw), ("tpool_slice", tpp.reference_impl),
        ("kernel", tpp.tpool_proto))


def shapes(batch: int):
    return [((batch * 5, 8, 56, 56, 256), "stage1"),
            ((batch * 5, 4, 28, 28, 512), "stage2"),
            ((batch * 5, 2, 14, 14, 1024), "stage3")]


def inputs(shape, dev):
    """(y, ident, a, b) of one row: standard normal bf16 y and ident from a
    generator seeded 0 on the device, a = 0.9 and b = 0.1."""
    gen = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    ident = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    c = shape[-1]
    return (y, ident, torch.full((c,), 0.9, device=dev),
            torch.full((c,), 0.1, device=dev))


def run(dev, batch: int = 8) -> list:
    """One dict per (shape, row)."""
    flush = l2_flush_buffer(dev)
    out = []
    for shape, name in shapes(batch):
        n, f, h, w, c = shape
        y, ident, a, b = inputs(shape, dev)
        nbytes = (2 * n * f + n * ((f + 1) // 2)) * h * w * c * 2
        ref = tpool_rw(y, ident, a, b)
        plain = tpp.reference_impl(y, ident, a, b)
        for label, fn in ROWS:
            got = fn(y, ident, a, b)
            torch.cuda.synchronize()
            ms = event_ms(lambda: fn(y, ident, a, b), flush=flush)
            out.append(dict(stage=name, shape=list(shape), row=label, ms=ms,
                            GBps=nbytes / ms / 1e6,
                            exact=bool(torch.equal(got, ref)),
                            max_abs_err=float((got.float()
                                               - ref.float()).abs().max()),
                            within_1ulp_of_plain=within_one_bf16_ulp(
                                got, plain)))
        del y, ident, ref, plain
    return out


def main() -> int:
    need_card()
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = torch.device("cuda", 0)
    print(json.dumps({"card": nvidia_smi()}), flush=True)
    for row in run(dev, batch):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
