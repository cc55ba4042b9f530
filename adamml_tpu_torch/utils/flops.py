"""Modeled GFLOPs for adaptive-selection reporting, and a FLOP count of a
model's forward (``adamml_tpu/utils/flops.py``).

1. The fixed per-segment cost table and the selection-rate-weighted total,
   numerically identical to the reference (reference
   utils/utils.py:510-535). It models what an ideal conditional executor
   would spend -- the reference never actually skips masked modalities
   (reference models/adamml.py:82-86).
2. ``count_model_flops``: the FLOPs of one forward, counted by
   ``torch.utils.flop_counter.FlopCounterMode`` (2 per multiply-add of
   the matmuls and convolutions, 2D and SlowFast's 3D alike: its formula
   takes every spatial and temporal axis of the output and the kernel;
   MViT's linear layers, both attention products and its relative-position
   einsums are matmuls to it).
   The JAX package takes XLA's cost analysis, which also counts
   elementwise work, so its count is higher.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

# Per-segment FLOPs tables (reference utils/utils.py:512-523), units: FLOPs.
MAIN_FLOPS: Dict[str, int] = {
    "rgb": 14_135_984_128,
    "flow": 16_338_911_232,
    "sound": 381_739_008,
}

POLICY_FLOPS: Dict[str, int] = {
    "rgb": 375_446_400,
    "sound": 381_739_008,
    "rgbdiff": 909_283_200,
    "lstm": 2_359_296,
}


def flops_computation(modality: Sequence[str], ratios: Mapping[str, float],
                      num_segments: int) -> float:
    """Selection-weighted modeled GFLOPs per video
    (reference utils/utils.py:510-535).

    `ratios` maps major-modality name -> mean selection rate in [0, 1].
    """
    total = 0.0
    for m in modality:
        if m in ("sound", "rgb"):
            total += MAIN_FLOPS[m] * num_segments * float(ratios[m])
            total += POLICY_FLOPS[m] * num_segments
        else:  # flow main net gated by the rgbdiff-proxy policy
            total += MAIN_FLOPS["flow"] * num_segments * float(ratios["flow"])
            total += POLICY_FLOPS["rgbdiff"] * num_segments
    total += POLICY_FLOPS["lstm"] * num_segments
    return total / 1e9


def count_model_flops(model: torch.nn.Module, *args, **kwargs) -> int:
    """FLOPs of ``model(*args, **kwargs)``, run once without gradients: 2
    per multiply-add of its matmuls and convolutions (the operations
    ``FlopCounterMode`` counts; elementwise work and the hand-written
    kernels count 0)."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(*args, **kwargs)
    return int(counter.get_total_flops())
