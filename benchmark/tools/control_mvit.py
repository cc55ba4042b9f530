#!/usr/bin/env python3
"""Readings of the MViTv2 cell's compared numbers from runs that must fail
them (benchmark/tools/control_unimodal.py's counterpart for the
``train_mvit`` entry): the control (the reference in the program's place,
its convolutions, matmuls and einsums rounded to float8 e4m3, one
precision below the configuration's bfloat16), half of the batch left out
(the mean taken over the rest), the state left unchanged, and a fault
confined to one stage (stage 2's leaves take half their clipped
gradient), each against the float32 reference on the same inputs, at the
cell's own size; and with ``--program`` the program's own numbers from its
first steps (the run's set-up and check, without the window).

    python3 benchmark/tools/control_mvit.py --workload mvitv2-s16x4.train \\
        --seeds 1 2 3 [--program]

One JSON line a seed and reading. Needs a CUDA card for the cell's size;
``--device cpu`` with a tiny cell is for the tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from benchmark.entries import train_mvit as entry  # noqa: E402
from benchmark.reference import mvit as ref  # noqa: E402

CONFINED = "s2"


def halve_confined(name: str, grad: torch.Tensor) -> torch.Tensor:
    return grad * 0.5 if entry.stage_of(name) == CONFINED else grad


def readings(cell, seed, device) -> dict:
    tr, block = cell.traffic, cell.config["reference"]
    spec = ref.Spec.from_dict(block)
    seeds = harness.Seeds.of(seed)
    batch, steps = tr["batch"], tr["check_steps"]
    pool = harness.source(tr["source"]).make(
        ["rgb"], samples=tr["pool_batches"] * batch, segments=1,
        frames_per_segment=spec.frames, canvas=tuple(block["canvas"]),
        wave_samples=1, num_classes=spec.num_classes, seed=seeds.data,
        device=device)
    args = (spec, block, pool, batch, steps, seeds, device)
    base = entry.follow(*args)
    unchanged = dict(base, update={k: 0.0 for k in base["update"]})
    return {"control": entry.numbers(entry.follow(*args, prec="fp8"), base),
            "half_batch": entry.numbers(
                entry.follow(*args, keep=batch // 2), base),
            "state_unchanged": entry.numbers(unchanged, base),
            "s2_half_grad": entry.numbers(
                entry.follow(*args, grad_hook=halve_confined), base)}


def program_numbers(cell, seed, device) -> dict:
    """The program's numbers: a run whose window is 0 s."""
    out = entry.run(cell, seed, 0.0, False, device, time.perf_counter())
    return out.ctx.numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_mvit.py: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    for seed in args.seeds:
        got = ({"program": program_numbers(cell, seed, dev)} if args.program
               else readings(cell, seed, dev))
        for kind, numbers in got.items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": kind, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
