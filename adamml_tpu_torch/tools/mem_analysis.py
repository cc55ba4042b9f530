#!/usr/bin/env python3
"""Where the device memory of one flagship train step goes: the port's
counterpart of tools/mem_analysis.py.

    python -m adamml_tpu_torch.tools.mem_analysis [--phase policy|main]
        [--batch 24] [--fused_tpool 0|1] [--remat_policy 0|1]
        [--remat_stages S ...] [--snapshot PATH]

Builds the flagship (``flagship_cfg``: bf16 compute, float32 parameters,
seeded random weights) with the fused epilogue and the policy trunks'
rematerialization as asked, and the train step of the phase (the policy
phase by default, as the JAX tool compiles it) at bench.py's settings, on
``--batch`` clips of ``example_inputs``. One warm-up step makes the
optimizer state; then one step runs with the caching allocator's history
recorded (``torch.cuda.memory._record_memory_history``). The JAX tool reads
XLA's compiled memory analysis without running; here the step runs, and
the allocator's own counters say what it held. Reported:

  arguments    ``torch.cuda.memory_allocated`` at the step's start, split
               into parameters, buffers (BN statistics), gradients,
               optimizer state, inputs and the rest;
  peak         the step's ``max_memory_allocated``, and temporaries (the
               peak less the arguments); ``memory_stats``' reserved peak;
  top blocks   the ten largest blocks allocated in the step and live at its
               peak, each with its allocation's frames in this repository
               (from ``torch.cuda.memory._snapshot()``'s trace, replayed to
               the peak); they replace the JAX tool's largest-buffer list
               and its ``ADAMML_HLO_OUT`` dump. ``--snapshot`` keeps the
               pickle (``torch.cuda.memory._dump_snapshot``);
  launches     the fused epilogue kernels' launches in the step
               (``ops/kernels/tpool_fused.py``'s counters).

The JAX tool's ``ADAMML_TPOOL_BWD=jnp`` A/B has no counterpart: the port's
plain backward serves CPU tensors only, and a CUDA tensor launches the
kernel or raises. ``--fused_tpool 0`` against ``1`` measures the fused
forward and backward pair against the unfused composition. Needs a CUDA
card; it raises without one, before it allocates anything. Prints JSON
lines.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models.model_builder import build_model, example_inputs
from adamml_tpu_torch.ops.kernels import tpool_fused as tp
from adamml_tpu_torch.tools.timing import nvidia_smi
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.steps import make_adamml_train_step
from adamml_tpu_torch.train.train_state import StageFlags, TrainState

TOP = 10
# the train step's settings (bench.py:156-161)
LR, P_LR, COST, GAMMAS = 1e-3, 1e-2, [1.0, 0.05], 10.0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phase", choices=("policy", "main"), default="policy")
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--fused_tpool", type=int, choices=(0, 1), default=1)
    p.add_argument("--remat_policy", type=int, choices=(0, 1), default=1)
    p.add_argument("--remat_stages", type=int, nargs="*", default=None,
                   help="ResNet stages to rematerialize (default: the "
                        "flagship's, none)")
    p.add_argument("--snapshot", default="",
                   help="keep the allocator's snapshot pickle here")
    return p.parse_args(argv)


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None and t.is_cuda)


def _frames(frames) -> list:
    """The allocation's Python frames in this repository, innermost first
    (else its two innermost Python frames; the autograd engine's backward
    allocates with none)."""
    ours = [f for f in frames if "adamml_tpu_torch" in f.get("filename", "")]
    return [f"{f['filename'].split('adamml_tpu_torch/')[-1]}:{f['line']} "
            f"{f['name']}" for f in (ours[:4] or frames[:2])] or [
                "no Python frame (the autograd engine)"]


def _peak_blocks(snapshot: dict, start: int, dev: int) -> tuple:
    """(replayed peak bytes, the blocks allocated in the recorded span and
    live at its peak): the device's trace of allocations and frees,
    replayed from ``start`` bytes allocated."""
    live, now, peak, at_peak = {}, start, start, {}
    for e in snapshot["device_traces"][dev]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            now += e["size"]
        elif e["action"] == "free_completed":
            now -= e["size"]
            live.pop(e["addr"], None)
        else:
            continue
        if now > peak:
            peak, at_peak = now, dict(live)
    return peak, sorted(at_peak.values(), key=lambda e: -e["size"])


def run(dev, phase: str = "policy", batch: int = 24, fused_tpool: int = 1,
        remat_policy: int = 1, remat_stages: Optional[Sequence[int]] = None,
        snapshot: str = "") -> dict:
    """The memory breakdown of one flagship train step on ``dev``."""
    dev = torch.device(dev)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"mem_analysis reads the CUDA caching "
                           f"allocator: it needs a CUDA device, not {dev}")
    cfg = flagship_cfg()
    cfg.model.fused_tpool = bool(fused_tpool)
    cfg.model.remat_policy = bool(remat_policy)
    if remat_stages is not None:
        cfg.model.remat_stages = tuple(remat_stages)
    model, name = build_model(cfg, dev)
    inputs = example_inputs(cfg, batch=batch, seed=0, device=dev)
    target = torch.zeros(batch, dtype=torch.long, device=dev)
    state = TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))
    step = make_adamml_train_step(
        model, flags=(StageFlags.main_phase() if phase == "main"
                      else StageFlags.policy_phase()),
        penalty_type="blockdrop", gammas=GAMMAS, clip_gradient=None)
    step(state, inputs, target, LR, P_LR, COST, seed=0)  # makes the state
    torch.cuda.synchronize(dev)

    params = list(model.parameters())
    opt_state = [v for opt in (state.main_opt, state.policy_opt)
                 for st in opt.state.values() for v in st.values()
                 if torch.is_tensor(v)]
    args = {"parameters": _bytes(params),
            "buffers": _bytes(model.buffers()),
            "gradients": _bytes(p.grad for p in params),
            "optimizer_state": _bytes(opt_state),
            "inputs": _bytes(inputs + [target])}
    start = torch.cuda.memory_allocated(dev)
    args["other"] = start - sum(args.values())
    torch.cuda.reset_peak_memory_stats(dev)
    before = dict(tp.launch_counts)
    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                             stacks="python")
    try:
        step(state, inputs, target, LR, P_LR, COST, seed=1)
        torch.cuda.synchronize(dev)
        snap = torch.cuda.memory._snapshot()
        if snapshot:
            torch.cuda.memory._dump_snapshot(snapshot)
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated(dev)
    reserved = torch.cuda.memory_stats(dev)["reserved_bytes.all.peak"]
    replayed, blocks = _peak_blocks(snap, start, dev.index or 0)
    out = {"arch": name, "curriculum_phase": phase, "batch_clips": batch,
           "fused_tpool": fused_tpool, "remat_policy": remat_policy,
           "remat_stages": list(cfg.model.remat_stages),
           "arguments_bytes": start, "arguments": args,
           "peak_bytes": peak, "temporaries_bytes": peak - start,
           "reserved_peak_bytes": reserved,
           "replayed_peak_bytes": replayed,
           "top_blocks": [{"bytes": e["size"], "frames": _frames(e["frames"])}
                          for e in blocks[:TOP]],
           "launches": {k: tp.launch_counts[k] - before[k]
                        for k in (tp.KERNEL, tp.KERNEL_BWD)}}
    del model, state, inputs, snap
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    a = parse_args(argv)
    res = run(torch.device("cuda", 0) if torch.cuda.is_available() else "cpu",
              a.phase, a.batch, a.fused_tpool, a.remat_policy,
              a.remat_stages, a.snapshot)
    print(json.dumps({"card": nvidia_smi()}), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
