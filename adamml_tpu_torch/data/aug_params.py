"""Host-side sampling of augmentation parameters (the port's copy of
``adamml_tpu/data/aug_params.py``).

The device op (ops/augment.py) applies one crop rectangle + flip flag per
sample per modality; this module draws those parameters with the same
distributions as the reference transforms:

  v2 train: random short-side scale in scale_range + random crop
            (reference utils/utils.py:131-135; GroupRandomScale at
            utils/video_transforms.py:102-119, GroupRandomCrop at :9-33)
  v1 train: TSN GroupMultiScaleCrop with scales [1, .875, .75, .66],
            max_distort 1, 13 fixed offsets
            (reference utils/utils.py:127-130, video_transforms.py:181-252)
  val:      short side -> round(input/0.875), center crop
            (reference utils/utils.py:138-142)

Flip probability 0.5 at train (reference video_transforms.py:44-59).
Rectangles are (x, y, w, h) in source-pixel coordinates.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

MULTISCALE_SCALES = (1.0, 0.875, 0.75, 0.66)
MAX_DISTORT = 1


def _fixed_offsets(image_w: int, image_h: int, crop_w: int, crop_h: int):
    """13 fixed crop anchors (reference video_transforms.py:229-252)."""
    w_step = (image_w - crop_w) // 4
    h_step = (image_h - crop_h) // 4
    ret = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
           (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step),
           (0, 2 * h_step), (4 * w_step, 2 * h_step),
           (2 * w_step, 4 * h_step), (2 * w_step, 0),
           (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
           (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step)]
    return ret


def _multiscale_crop(h: int, w: int, input_size: int,
                     rng: np.random.RandomState) -> Tuple[float, float, float, float]:
    base = min(w, h)
    crop_sizes = [int(base * s) for s in MULTISCALE_SCALES]
    # snap near-input sizes to the input size (reference :207-208)
    crop_hs = [input_size if abs(x - input_size) < 3 else x for x in crop_sizes]
    crop_ws = [input_size if abs(x - input_size) < 3 else x for x in crop_sizes]
    pairs = [(cw, ch) for i, ch in enumerate(crop_hs)
             for j, cw in enumerate(crop_ws) if abs(i - j) <= MAX_DISTORT]
    cw, ch = pairs[rng.randint(len(pairs))]
    offsets = _fixed_offsets(w, h, cw, ch)
    ox, oy = offsets[rng.randint(len(offsets))]
    return float(ox), float(oy), float(cw), float(ch)


def _scaled_wh(h: int, w: int, size: int) -> Tuple[int, int]:
    """(sw, sh) after a short-side resize to `size` with torchvision
    semantics: the long side is int(size * long / short) -- TRUNCATED, not
    rounded (reference GroupScale delegates to torchvision.transforms.Resize,
    video_transforms.py:87-100; e.g. 340x256 -> 224 gives 297, and a
    round() here would shift the crop-offset range by one pixel)."""
    if h <= w:
        return int(size * w / h), size
    return size, int(size * h / w)


def _random_sized_crop(h: int, w: int, input_size: int,
                       rng: np.random.RandomState
                       ) -> Tuple[float, float, float, float]:
    """Inception-style random sized crop (reference GroupRandomSizedCrop,
    utils/video_transforms.py:255-298 -- present in the reference transform
    library but unused by its get_augmentor): 10 attempts at a crop of area
    uniform in [0.08, 1.0] x the image and aspect uniform in [3/4, 4/3]
    (sides swapped with p=0.5); the rect is resized to (input, input), so a
    non-square rect distorts, as in the original. Fallback after 10 misses:
    short side -> input scale + random input x input crop (reference
    :294-298)."""
    area = float(w) * float(h)
    for _ in range(10):
        target_area = rng.uniform(0.08, 1.0) * area
        aspect = rng.uniform(3.0 / 4.0, 4.0 / 3.0)
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if rng.random_sample() < 0.5:
            cw, ch = ch, cw
        if cw <= w and ch <= h:
            # reference random.randint is INCLUSIVE of both ends
            x1 = rng.randint(0, w - cw + 1)
            y1 = rng.randint(0, h - ch + 1)
            return float(x1), float(y1), float(cw), float(ch)
    # fallback: GroupScale(input) + GroupRandomCrop(input), expressed in
    # source coordinates for the fused device crop-resize
    f = input_size / min(h, w)
    sw, sh = _scaled_wh(h, w, input_size)
    crop_src = input_size / f
    x1 = rng.randint(0, max(sw - input_size, 0) + 1) / f
    y1 = rng.randint(0, max(sh - input_size, 0) + 1) / f
    return float(x1), float(y1), float(crop_src), float(crop_src)


# index of the canonical (center, unflipped) crop within the oversample
# rectangle list -- 10-crop interleaves [c0, c0_flip, c1, c1_flip, ...]
# following reference GroupOverSample's extend order (video_transforms.py:164-177)
OVERSAMPLE_CENTER = {1: 0, 3: 2, 5: 4, 10: 8}


def oversample_crop_flip(hw: np.ndarray, *, input_size: int, num_crops: int,
                         disable_scaleup: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic multi-crop eval rectangles (reference GroupOverSample,
    utils/video_transforms.py:121-178): scale the short side to
    input/0.875, then take 3 (top/bottom/left/right + center along the long
    axis), 5 (4 corners + center, fill_fix_offset :229-252), or 10 (5 x
    {normal, mirrored}) fixed crops. Offsets are computed in SCALED image
    coordinates exactly like the reference and mapped back to source
    coordinates for the fused device crop-resize op.

    hw: (N, 2) true (h, w). Returns (crops (N, C, 4) xywh, flips (N, C))."""
    if num_crops not in (1, 3, 5, 10):
        raise ValueError(
            f"num_crops should be in [1, 3, 5, 10] but ({num_crops})")
    n = hw.shape[0]
    crops = np.zeros((n, num_crops, 4), np.float32)
    flips = np.zeros((n, num_crops), bool)
    for i in range(n):
        h, w = int(hw[i, 0]), int(hw[i, 1])
        scaled = (input_size if disable_scaleup
                  else int(input_size / 0.875 + 0.5))
        f = scaled / min(h, w)
        sw, sh = _scaled_wh(h, w, scaled)  # scaled dims, Resize truncation
        crop_src = input_size / f
        if num_crops == 3:
            w_step = (sw - input_size) // 4
            h_step = (sh - input_size) // 4
            if sw < sh:  # portrait: top / bottom / center
                offs = [(2 * w_step, 0), (2 * w_step, 4 * h_step),
                        (2 * w_step, 2 * h_step)]
            else:  # landscape: left / right / center
                offs = [(0, 2 * h_step), (4 * w_step, 2 * h_step),
                        (2 * w_step, 2 * h_step)]
            fl = [False] * 3
        else:
            offs5 = _fixed_offsets(sw, sh, input_size, input_size)[:5]
            if num_crops == 5:
                offs, fl = offs5, [False] * 5
            elif num_crops == 10:
                offs = [o for o in offs5 for _ in range(2)]
                fl = [False, True] * 5
            else:  # num_crops == 1: center crop
                offs, fl = [offs5[4]], [False]
        for j, ((ox, oy), flip) in enumerate(zip(offs, fl)):
            crops[i, j] = (ox / f, oy / f, crop_src, crop_src)
            flips[i, j] = flip
    return crops, flips


def sample_crop_flip(hw: np.ndarray, *, input_size: int, train: bool,
                     version: str = "v2",
                     scale_range: Sequence[int] = (256, 320),
                     disable_scaleup: bool = False,
                     rng: Optional[np.random.RandomState] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """hw: (N, 2) true image (h, w) per sample.
    Returns (crop_xywh (N, 4) float32, flip (N,) bool)."""
    rng = np.random if rng is None else rng
    n = hw.shape[0]
    crops = np.zeros((n, 4), np.float32)
    flips = np.zeros((n,), bool)
    for i in range(n):
        h, w = int(hw[i, 0]), int(hw[i, 1])
        if train and version == "v1":
            crops[i] = _multiscale_crop(h, w, input_size, rng)
            flips[i] = rng.random_sample() < 0.5
        elif train and version == "random_sized":
            crops[i] = _random_sized_crop(h, w, input_size, rng)
            flips[i] = rng.random_sample() < 0.5
        elif train:
            s = rng.randint(scale_range[0], scale_range[1] + 1)
            f = s / min(h, w)
            crop_src = input_size / f
            x1 = rng.random_sample() * max(0.0, w - crop_src)
            y1 = rng.random_sample() * max(0.0, h - crop_src)
            crops[i] = (x1, y1, crop_src, crop_src)
            flips[i] = rng.random_sample() < 0.5
        else:
            scaled = input_size if disable_scaleup else int(
                input_size / 0.875 + 0.5)
            f = scaled / min(h, w)
            crop_src = input_size / f
            x1 = max(0.0, (w - crop_src) / 2.0)
            y1 = max(0.0, (h - crop_src) / 2.0)
            crops[i] = (x1, y1, crop_src, crop_src)
    return crops, flips
