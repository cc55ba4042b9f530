"""Inputs of the crop-resize kernel (``ops/kernels/crop_resize.py``) for its
checks: the CPU tests (``tests/test_torch_crop_resize.py``), the card tests
(``tests/test_torch_gpu.py -k crop_resize``) and ``chip_smoke.py``.

  MODALITIES   (C, cons, rgbdiff, flow) of each visual modality, as
               ``data/device_pipeline.py`` preprocesses it
  AXIS_CASES   (canvas size, output size, crop origin, crop extent) along
               one axis: minifying, magnifying, edge-crossing, outside the
               canvas, sub-pixel, negative and empty crops
  ODD_CROPS    crops on a 40 x 64 canvas with their flips, for
               ``odd_inputs``
  STEP_CASES   the visual modalities each train cell of the benchmark
               preprocesses a step, at full size, for ``step_inputs``
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.config import modality_mean, modality_std
from ..data.aug_params import sample_crop_flip

MODALITIES = {"rgb": (3, 1, False, False), "flow": (2, 5, False, True),
              "rgbdiff": (3, 5, True, False)}

AXIS_CASES = {
    "minify_8x": (64, 8, 0.0, 64.0),
    "minify_58x": (464, 8, 0.0, 464.0),
    "minify_fractional": (64, 16, 3.3, 53.75),
    "train_crop": (464, 224, 131.7, 179.2),
    "train_crop_full": (256, 224, 0.0, 224.0),
    "eval_centre": (464, 224, 120.0, 224.0),
    "magnify": (64, 48, 3.3, 20.5),
    "sub_pixel_3p5": (64, 48, 12.75, 3.5),
    "sub_pixel_0p6": (40, 16, 7.2, 0.6),
    "past_right_edge": (64, 16, 50.5, 20.0),
    "before_left_edge": (64, 16, -5.25, 20.0),
    "wider_than_canvas": (40, 16, -10.0, 60.0),
    "outside_right": (64, 8, 70.0, 10.0),
    "outside_left": (64, 8, -30.0, 10.0),
    "negative_extent": (64, 8, 40.0, -20.0),
    "empty": (64, 8, 10.0, 0.0),
}

# (x0, y0, w, h) on a 40 x 64 canvas, as tests/test_torch_data.py's CROPS:
# whole canvas, fractional origins, edge crossings, a crop past the canvas,
# the 3.5-pixel crop, a wide one, and one wholly outside
ODD_CROPS = [[0, 0, 64, 40], [3.3, 1.7, 20.5, 30.2],
             [10.25, 5.5, 53.75, 34.5], [0.5, 0.1, 7.3, 9.1],
             [44, 20, 20, 20], [50.5, 30.5, 20, 15],
             [12.75, 8.125, 3.5, 4.25], [0, 12, 64, 16], [70, 45, 10, 10]]
ODD_FLIPS = [True, False, True, False, True, True, False, True, True]

# (label, modality, clips, canvas frames a clip, canvas H, W): the visual
# modalities the benchmark's train cells preprocess a step, at 224 px
STEP_CASES = [
    ("flagship_rgb", "rgb", 18, 40, 256, 464),
    ("rgbflow_rgb", "rgb", 9, 40, 256, 464),
    ("rgbflow_flow", "flow", 9, 200, 256, 464),
    ("rgbflow_rgbdiff", "rgbdiff", 9, 240, 256, 464),
    ("slowfast_rgb", "rgb", 64, 32, 256, 340),
]
STEP_OUT = 224


def _kernel_args(modality: str, frames, crop, flip, out_size: int,
                 mean, std, ncrops: int = 1) -> dict:
    """``crop_resize.crop_resize``'s keyword arguments."""
    c, cons, rgbdiff, flow = MODALITIES[modality]
    return dict(frames=frames, crop_xywh=crop, flip=flip, out_size=out_size,
                mean=mean, std=std, flow=flow, rgbdiff=rgbdiff, cons=cons,
                ncrops=ncrops)


def odd_inputs(modality: str, ncrops: int, out_size: int, normalize: bool,
               device, seed: int = 0) -> dict:
    """Random canvases of ``modality`` on ``device``, two output frames a
    clip, with ODD_CROPS folded ``ncrops`` a canvas (the crops that fill
    whole canvases), and a made-up mean and std or none."""
    c, cons, rgbdiff, _ = MODALITIES[modality]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    nc = len(ODD_CROPS) // ncrops
    t_in = 2 * (cons + 1 if rgbdiff else cons)
    frames = torch.randint(0, 256, (nc, t_in, 40, 64, c), generator=gen,
                           dtype=torch.uint8, device=device)
    n = nc * ncrops
    return _kernel_args(
        modality, frames, torch.tensor(ODD_CROPS[:n], device=device),
        torch.tensor(ODD_FLIPS[:n], device=device), out_size,
        (0.5, 0.45, 0.4)[:c] if normalize else None,
        (0.2, 0.25, 0.3)[:c] if normalize else None, ncrops)


def step_inputs(case, device, seed: int) -> dict:
    """One step's canvases of a STEP_CASES row, random uint8 on ``device``
    (pictures 256 high and 256 to W wide, as the benchmark's canvas pool
    makes them), train crops and flips as the loader draws them
    (``data/aug_params.sample_crop_flip``, short side 256-320), and the
    modality's mean and std over C."""
    _, modality, n, t, h, w = case
    c = MODALITIES[modality][0]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.randint(0, 256, (n, t, h, w, c), generator=gen,
                           dtype=torch.uint8, device=device)
    rs = np.random.RandomState(seed)
    hw = np.stack([np.full(n, h), rs.randint(256, w + 1, n)], 1)
    crop, flip = sample_crop_flip(hw, input_size=STEP_OUT, train=True,
                                  scale_range=(256, 320), rng=rs)
    mean, std = modality_mean(modality), modality_std(modality)
    reps = c // len(mean)
    return _kernel_args(modality, frames, torch.from_numpy(crop).to(device),
                        torch.from_numpy(flip).to(device), STEP_OUT,
                        tuple(mean) * reps, tuple(std) * reps)
