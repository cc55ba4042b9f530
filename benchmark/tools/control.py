#!/usr/bin/env python3
"""Readings of a cell's compared numbers from runs that must fail them:
the control (the reference in the program's place, its convolutions and
matmuls rounded to float8 e4m3, one precision below the configurations'
bfloat16) and the faults a cell can have (half of the batch left out, the
mean taken over the rest; an answer altered), each against the float32
reference on the same inputs, at the cell's own size.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1 2 3

One JSON line a seed and reading. Needs a CUDA card for the cells' sizes;
``--device cpu`` with a tiny cell is for the tests.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import check, harness  # noqa: E402
from benchmark.entries import serve, train_epoch  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402


def _pool(cell, spec, seeds, device, segments):
    tr = cell.traffic
    return harness.source(tr["source"]).make(
        list(spec.modality), samples=tr["pool_batches"] * tr["batch"],
        segments=segments, frames_per_segment=spec.frames,
        canvas=spec.canvas,
        wave_samples=round(spec.resampling_rate * spec.audio_length),
        num_classes=spec.num_classes, seed=seeds.data, device=device)


def train_readings(cell, seed, device):
    tr = cell.traffic
    spec = ref.Spec.from_dict(cell.config["reference"])
    seeds = harness.Seeds.of(seed)
    pool = _pool(cell, spec, seeds, device, spec.segments)
    phase, batch, steps = tr["phase"], tr["batch"], tr["check_steps"]
    cost = ([0.0] * len(spec.main_modality) if phase == "main"
            else list(spec.cost_weights))
    args = (spec, pool, phase, batch, steps, seeds, device, cost)
    base = train_epoch.follow(*args)
    return {"control": check.train_numbers(
                train_epoch.follow(*args, prec="fp8"), base),
            "half_batch": check.train_numbers(
                train_epoch.follow(*args, keep=batch // 2), base)}


def serve_readings(cell, seed, device):
    tr = cell.traffic
    spec = ref.Spec.from_dict(cell.config["reference"])
    seeds = harness.Seeds.of(seed)
    pool = _pool(cell, spec, seeds, device, tr["segments"])
    rng = np.random.default_rng(seeds.check)
    picked = sorted(rng.choice(100, size=tr["check_requests"],
                               replace=False).tolist())
    base = serve.answer(spec, pool, tr["batch"], tr["segments"], picked,
                        seeds, device)
    fp8 = serve.answer(spec, pool, tr["batch"], tr["segments"], picked,
                       seeds, device, prec="fp8")
    half = []
    for lg, dec in base:
        lg = lg.copy()
        lg[len(lg) // 2:] = lg[:len(lg) // 2].mean(0)
        half.append((lg, dec))
    altered = [(lg + (np.arange(lg.size).reshape(lg.shape) == 0), dec)
               for lg, dec in base]
    # the policy's decisions flipped in every clip of a request but one
    flipped = []
    for lg, dec in base:
        dec = dec.copy()
        dec[1:] = 1 - dec[1:]
        flipped.append((lg, dec))
    return {"control": check.serve_numbers(fp8, base),
            "half_batch": check.serve_numbers(half, base),
            "answer_altered": check.serve_numbers(altered, base),
            "decisions_altered": check.serve_numbers(flipped, base)}


def readings(cell, seed, device):
    if cell.traffic["entry"] == "serve":
        return serve_readings(cell, seed, device)
    return train_readings(cell, seed, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        for kind, numbers in readings(cell, seed,
                                      torch.device("cuda")).items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": kind, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
