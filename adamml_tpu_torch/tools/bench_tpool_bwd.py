#!/usr/bin/env python3
"""The fused epilogue's backward kernel on its launch plan and on other
plans, at the flagship's three stage-boundary train shapes, beside a
streaming reference.

    python -m adamml_tpu_torch.tools.bench_tpool_bwd [batch=8]

Rows, each at batch x 5 rows of (8, 56, 56, 256), (4, 28, 28, 512) and
(2, 14, 14, 1024), bf16, the grouped affine R = 1, S = 5:

  plan       the kernel on ``tpool_fused.bwd_plan``'s plan;
  one_wave   the kernel with as many chunks a row as fill the card's
             resident blocks once (at most the plan's), the plan's slice
             groups: few long blocks;
  one_group  the kernel with the plan's chunks and one slice group;
  add        PyTorch's ``torch.add(y, ident, out=...)`` at the same shape: a
             streaming reference (two tensors read, one written), not the
             same function.

Each prints one JSON line: CUDA-event ms with the L2 flushed between runs
(mean of 20 after 3), the bound (the row's bytes over 3.35 TB/s: the
kernel's y, ident and ct read and dy and dident written once; add's three
tensors) and the share of it, the plan's blocks, chunks, slice groups,
waves and partials bytes, and for the kernel rows whether dy and dident
equal the plan row's bit for bit and da and db are within 1e-4 of its
largest entry (other chunks add in another order). Needs a CUDA card; it
raises without one.
"""

from __future__ import annotations

import json
import sys

import torch

from adamml_tpu_torch.ops.kernels import tpool_fused as tp
from adamml_tpu_torch.tools.timing import (HBM_BYTES_PER_S, event_ms,
                                           l2_flush_buffer, need_card,
                                           nvidia_smi)

PLAN_KEYS = ("blocks", "chunks", "slice_groups", "waves", "partials_bytes")


def shapes(batch: int):
    return [((batch * 5, 8, 56, 56, 256), "stage1"),
            ((batch * 5, 4, 28, 28, 512), "stage2"),
            ((batch * 5, 2, 14, 14, 1024), "stage3")]


def inputs(shape, dev):
    """(y, ident, a, b, ct) of one stage: standard normal bf16 y, ident and
    ct, a = 1 + 0.3 N(0, 1), b = 0.1 N(0, 1) per (segment, channel), from a
    generator seeded 0 on the device."""
    n, f, h, w, c = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    y, ident = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    a = 1.0 + 0.3 * torch.randn((1, 5, c), generator=gen, device=dev)
    b = 0.1 * torch.randn((1, 5, c), generator=gen, device=dev)
    ct = torch.randn((n, (f - 1) // 2 + 1, h, w, c), generator=gen,
                     device=dev).to(torch.bfloat16)
    return y, ident, a, b, ct


def plans(shape, sms: int) -> dict:
    """The rows' plans: the planned one, then one wave of long blocks, then
    the planned chunks in one slice group; a row whose plan is an earlier
    row's is left out."""
    n, f, h, w, c = shape
    plan = tp.bwd_plan(n, f, h, w, c, 2, sms)
    fill = max(1, min(plan["chunks"], sms * tp.BWD_BLOCKS_PER_SM // n))
    rows = {"plan": plan,
            "one_wave": tp.bwd_plan(n, f, h, w, c, 2, sms, chunks=fill,
                                    slice_groups=plan["slice_groups"]),
            "one_group": tp.bwd_plan(n, f, h, w, c, 2, sms,
                                     slice_groups=1)}
    out, seen = {}, set()
    for label, p in rows.items():
        if (p["chunks"], p["slice_groups"]) not in seen:
            seen.add((p["chunks"], p["slice_groups"]))
            out[label] = p
    return out


def run(dev, batch: int = 8) -> list:
    """One dict per (shape, row)."""
    flush = l2_flush_buffer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for shape, name in shapes(batch):
        n, f, h, w, c = shape
        args = inputs(shape, dev)
        fo = (f - 1) // 2 + 1
        nbytes = (4 * n * f + n * fo) * h * w * c * 2
        want = None
        for label, plan in plans(shape, sms).items():
            got = tp._launch_bwd_rows(*args, plan=plan)
            torch.cuda.synchronize()
            want = want or got
            rel = float((got[2] - want[2]).abs().max()
                        / want[2].abs().max())
            ms = event_ms(lambda: tp._launch_bwd_rows(*args, plan=plan),
                          flush=flush)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            out.append(dict(stage=name, shape=list(shape), row=label, ms=ms,
                            bound_ms=bound, share_of_bound=bound / ms,
                            dy_dident_equal=bool(
                                torch.equal(got[0], want[0])
                                and torch.equal(got[1], want[1])),
                            rows_rel_err=rel, rows_within_1e4=rel <= 1e-4,
                            **{k: plan[k] for k in PLAN_KEYS}))
            del got
        y, ident = args[:2]
        dst = torch.empty_like(y)
        ms = event_ms(lambda: torch.add(y, ident, out=dst), flush=flush)
        bound = 3 * y.numel() * 2 / HBM_BYTES_PER_S * 1e3
        out.append(dict(stage=name, shape=list(shape), row="add", ms=ms,
                        bound_ms=bound, share_of_bound=bound / ms))
        del args, want, y, ident, dst
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    need_card()
    batch = int(argv[0]) if argv else 8
    dev = torch.device("cuda", 0)
    print(json.dumps({"card": nvidia_smi()}), flush=True)
    for row in run(dev, batch):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
