#!/usr/bin/env python3
"""The cost of one optimizer update on the card: the port's counterpart of
tools/bench_update.py.

    python -m adamml_tpu_torch.tools.bench_update [--iters 30] [--warmup 3]

Over the flagship's parameters (``flagship_cfg``, seeded random weights):
the main net under the port's SGD and the policy net under its Adam, as
``build_optimizer`` makes them from the flagship's settings (lr 0.01,
momentum 0.9, weight decay 1e-4; the JAX tool's). Three rows each:

  per_tensor  the optimizer at ``foreach=False`` (``--no_fused_update``):
              one update per tensor (the JAX tool's "optax" row);
  foreach     the optimizer as the flagship runs it (``_foreach`` ops over
              every tensor at once);
  vector      the same optimizer over one flat float32 parameter that holds
              every element: the same update with no tree and no ravel (the
              JAX tool's "pure vector" row).

Every row starts from the same parameters, gradients (standard normal x
1e-3) and empty state, and takes the same updates, the gradients rescaled
by 1 + 1e-6 before each (outside the timed span), as the JAX tool varies
them. Each row reports the ms of one update (CUDA events around it, the
card idle before it, so a host that launches slower than the card runs is
counted: the median of ``--iters`` after ``--warmup``), the parameters and
tensors, the kernels one update puts on the card (a device trace), the
bound (the bytes the update must move over the memory rate: SGD reads p,
g, buf and writes p, buf, 20 bytes a parameter; Adam reads p, g, m, v and
writes p, m, v, 28) and the share of the bound reached. Then the rows'
agreement: the parameters and state each leaves, against the foreach row,
bit for bit or else the largest difference relative to the tensor's
largest value.

On the CPU (the tests, ``run(torch.device("cpu"), tiny=True)``) it takes
the updates without timing them. Prints JSON lines; ``main`` needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List

import torch

from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models.model_builder import build_model
from adamml_tpu_torch.tools.timing import (HBM_BYTES_PER_S, device_trace,
                                           need_card, nvidia_smi)
from adamml_tpu_torch.train.optim import build_optimizer, set_lr

ROWS = ("per_tensor", "foreach", "vector")
# (optimizer kind of build_optimizer, subnet, bytes a parameter)
OPTIMIZERS = {"sgd": ("main", "main_net", 20), "adam": ("policy",
                                                         "policy_net", 28)}
LR = 0.01


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--warmup", type=int, default=3)
    return p.parse_args(argv)


def _row_optimizer(row: str, kind: str, start: List[torch.Tensor]):
    """(optimizer, its parameters) of one row, from copies of ``start``."""
    cfg = flagship_cfg().optim
    cfg.fused_update = row != "per_tensor"
    if row == "vector":
        params = [torch.nn.Parameter(torch.cat([p.reshape(-1)
                                                for p in start]))]
    else:
        params = [torch.nn.Parameter(p.clone()) for p in start]
    opt = build_optimizer(OPTIMIZERS[kind][0], cfg, params)
    set_lr(opt, LR)
    return opt, params


def _split(flat: torch.Tensor, like: List[torch.Tensor]):
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def _leaves(row, opt, params, like) -> Dict[str, List[torch.Tensor]]:
    """The parameters and every state entry of a row, per tensor."""
    def per_tensor(ts):
        return _split(ts[0], like) if row == "vector" else list(ts)

    out = {"param": per_tensor([p.detach() for p in params])}
    keys = [k for k in opt.state[params[0]] if k != "step"]
    for k in keys:
        out[k] = per_tensor([opt.state[p][k] for p in params])
    out["step"] = [opt.state[p]["step"] for p in params] if (
        "step" in opt.state[params[0]]) else []
    return out


def _agreement(got, want) -> dict:
    """Bit for bit, or the largest difference over the tensor's largest
    value, of each entry."""
    out = {}
    for k, ws in want.items():
        gs = got[k]
        if k == "step":  # one count per tensor, or one for the vector
            out[k] = {"bitwise": all(torch.equal(g, ws[0]) for g in gs + ws)}
            continue
        exact = all(torch.equal(g, w) for g, w in zip(gs, ws))
        rel = max(float((g.double() - w.double()).abs().max()
                        / w.double().abs().max().clamp_min(1e-30))
                  for g, w in zip(gs, ws))
        out[k] = {"bitwise": exact, "max_rel_diff": rel}
    return out


def run(dev, tiny: bool = False, iters: int = 30, warmup: int = 3) -> list:
    """One dict per (optimizer, row), then one agreement dict per
    optimizer."""
    timed = dev.type == "cuda"
    model, _ = build_model(flagship_cfg(tiny=tiny), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for kind, (_, subnet, per_param) in OPTIMIZERS.items():
        start = [p.detach().clone()
                 for p in getattr(model, subnet).parameters()]
        g0 = [torch.randn(p.shape, generator=gen, device=dev) * 1e-3
              for p in start]
        n = sum(p.numel() for p in start)
        bound = n * per_param / HBM_BYTES_PER_S * 1e3
        leaves = {}
        for row in ROWS:
            opt, params = _row_optimizer(row, kind, start)
            grads = [torch.cat([g.reshape(-1) for g in g0])] if (
                row == "vector") else [g.clone() for g in g0]
            for p, g in zip(params, grads):
                p.grad = g
            ms = []
            for i in range(warmup + iters):
                torch._foreach_mul_(grads, 1.0 + 1e-6)
                if not timed:
                    opt.step()
                    continue
                start_ev = torch.cuda.Event(enable_timing=True)
                end_ev = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start_ev.record()
                opt.step()
                end_ev.record()
                torch.cuda.synchronize()
                if i >= warmup:
                    ms.append(start_ev.elapsed_time(end_ev))
            # one more update, traced (every row takes it)
            launches = len(device_trace(opt.step)[0]) if timed else None
            leaves[row] = _leaves(row, opt, params, start)
            med = statistics.median(ms) if ms else None
            out.append({"optimizer": kind, "row": row, "parameters": n,
                        "tensors": len(start),
                        "updates": warmup + iters + timed, "ms": med,
                        "ms_min": min(ms) if ms else None,
                        "ms_max": max(ms) if ms else None,
                        "launches_per_update": launches,
                        "bound_ms": bound, "bound_bytes_per_param": per_param,
                        "share_of_bound": bound / med if med else None})
        out.append({"optimizer": kind, "agreement": {
            row: _agreement(leaves[row], leaves["foreach"])
            for row in ROWS if row != "foreach"}})
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    need_card()
    dev = torch.device("cuda", 0)
    print(json.dumps({"card": nvidia_smi()}), flush=True)
    for row in run(dev, iters=args.iters, warmup=args.warmup):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
