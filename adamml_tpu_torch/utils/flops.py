"""Modeled GFLOPs for adaptive-selection reporting (the port's copy of the
cost table and ``flops_computation`` of ``adamml_tpu/utils/flops.py``).

The fixed per-segment cost table and the selection-rate-weighted total,
numerically identical to the reference (reference utils/utils.py:510-535).
It models what an ideal conditional executor would spend -- the reference
never actually skips masked modalities (reference models/adamml.py:82-86).
The analytic per-module counter (``count_model_flops``) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

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
