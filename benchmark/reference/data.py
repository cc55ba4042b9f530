"""Plain inputs of the reference: which clips a batch holds, where each is
cropped, and the preprocessing on the device, from the raw canvases and
waveforms that the benchmark made (benchmark/sources).

- Train batches: the epoch's order is NumPy's ``RandomState(seed +
  epoch).permutation(dataset length)``; batch k takes the next B dataset
  indices, and dataset index i reads raw sample i mod the pool size. One
  ``RandomState((seed + 7919 (epoch + 1)) mod 2^31)`` draws every batch's
  crops in turn, modality by modality: a short side uniform in the scale
  range, a square crop of input_size at that scale, its corner uniform in
  the image, a flip with probability 1/2 (TSN's GroupScale and
  GroupRandomCrop, IBM/AdaMML utils/utils.py:131-135).
- Eval: a centre crop of input_size at short side round(input_size /
  0.875), no flip (utils/utils.py:138-142).
- Crop-resize: linear, antialiased resampling of the crop rectangle to
  input_size x input_size (jax.image.scale_and_translate's triangle filter,
  widened by 1/scale when it shrinks, each output normalised by its
  weights and zeroed when its sample centre falls off the canvas); then
  the flip (flow's x channel inverts as 255 - v), then (v / 255 - mean) /
  std.
- rgbdiff: floor((b - a + 255) * 255 / 510) of 6 consecutive frames, 5 a
  sampled frame (utils/video_dataset.py:32-38); flow: 5 frames of 2
  channels. Both stack their 5 frames into the channels, frame-major.
- Sound: log(|STFT|^2 + 1e-6) of each segment's 1.28 s at 24 kHz, n_fft 511,
  a periodic Hann window of 10 ms centred in it, 5 ms hop, zero padding of
  255 samples a side: 256 x 256 (frequency, time); zero where the wave is
  missing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FLOW_MEAN = (0.5,)
FLOW_STD = (sum(IMAGENET_STD) / 3.0,)
STACKED = {"rgb": 1, "flow": 5, "rgbdiff": 5}


def train_order(length: int, seed: int, epoch: int = 0) -> np.ndarray:
    return np.random.RandomState(seed + epoch).permutation(length)


def crop_rng(seed: int, epoch: int = 0) -> np.random.RandomState:
    return np.random.RandomState((seed + 7919 * (epoch + 1)) % (2 ** 31))


def train_crops(hw: np.ndarray, rng: np.random.RandomState, input_size: int,
                scale_range) -> Tuple[np.ndarray, np.ndarray]:
    crops = np.zeros((len(hw), 4), np.float32)
    flips = np.zeros((len(hw),), bool)
    for i, (h, w) in enumerate(hw.tolist()):
        short = rng.randint(scale_range[0], scale_range[1] + 1)
        side = input_size * min(h, w) / short
        x0 = rng.random_sample() * max(0.0, w - side)
        y0 = rng.random_sample() * max(0.0, h - side)
        crops[i] = (x0, y0, side, side)
        flips[i] = rng.random_sample() < 0.5
    return crops, flips


def center_crops(hw: np.ndarray, input_size: int) -> np.ndarray:
    scaled = int(input_size / 0.875 + 0.5)
    crops = np.zeros((len(hw), 4), np.float32)
    for i, (h, w) in enumerate(hw.tolist()):
        side = input_size * min(h, w) / scaled
        crops[i] = (max(0.0, (w - side) / 2), max(0.0, (h - side) / 2),
                    side, side)
    return crops


def train_batches(pool, visual: List[str], batch: int, count: int,
                  length: int, seed: int, input_size: int, scale_range
                  ) -> List[dict]:
    """The first ``count`` train batches of epoch 0: pool indices, and per
    visual modality its crops and flips."""
    order = train_order(length, seed)
    rng = crop_rng(seed)
    out = []
    for k in range(count):
        idx = order[k * batch:(k + 1) * batch] % pool.size
        b = {"index": idx}
        for m in visual:
            b[m] = train_crops(pool.hw[idx], rng, input_size, scale_range)
        out.append(b)
    return out


def _resample(in_size: int, out_size: int, scale: torch.Tensor,
              shift: torch.Tensor) -> torch.Tensor:
    """(N, out, in) weights of a linear antialiased resample, per sample."""
    dev = scale.device
    inv = 1.0 / scale[:, None, None]
    width = torch.clamp(inv, min=1.0)
    centre = ((torch.arange(out_size, device=dev, dtype=torch.float32)
               [None, :, None] + 0.5) * inv - shift[:, None, None] * inv
              - 0.5)
    src = torch.arange(in_size, device=dev, dtype=torch.float32)
    wts = torch.clamp(1.0 - (centre - src[None, None, :]).abs() / width,
                      min=0.0)
    total = wts.sum(2, keepdim=True)
    tiny = 1000.0 * torch.finfo(torch.float32).eps
    wts = torch.where(total.abs() > tiny,
                      wts / torch.where(total != 0, total,
                                        torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (centre >= -0.5) & (centre <= in_size - 0.5)
    return torch.where(inside, wts, torch.zeros_like(wts))


def crop_resize(frames: torch.Tensor, crops: torch.Tensor,
                flips: torch.Tensor, size: int, mean, std,
                flow: bool) -> torch.Tensor:
    """frames (N, T, H, W, C) float32 0-255 -> (N, T, size, size, C)."""
    n, t, h, w, c = frames.shape
    x0, y0, cw, ch = crops.unbind(1)
    sy, sx = size / ch, size / cw
    wy = _resample(h, size, sy, -y0 * sy)
    wx = _resample(w, size, sx, -x0 * sx)
    out = torch.einsum("nthwc,nph->ntpwc", frames, wy)
    out = torch.einsum("ntpwc,nqw->ntpqc", out, wx)
    flipped = out.flip(3)
    if flow:
        flipped = torch.cat([255.0 - flipped[..., :1], flipped[..., 1:]], -1)
    out = torch.where(flips.view(n, 1, 1, 1, 1), flipped, out)
    reps = c // len(mean)
    mean = torch.tensor(mean * reps, device=out.device)
    std = torch.tensor(std * reps, device=out.device)
    return (out / 255.0 - mean) / std


def rgb_difference(frames: torch.Tensor) -> torch.Tensor:
    """(N, P * 6, H, W, C) consecutive frames -> (N, P * 5, H, W, C)."""
    n, t = frames.shape[:2]
    v = frames.reshape((n, t // 6, 6) + tuple(frames.shape[2:]))
    d = torch.floor((v[:, :, 1:] - v[:, :, :-1] + 255.0) * (255.0 / 510.0))
    return d.reshape((n, t // 6 * 5) + tuple(frames.shape[2:]))


def spectrogram(wave: torch.Tensor, rate: int, seconds: float
                ) -> torch.Tensor:
    """(..., L) -> (..., 256, frames) log power."""
    n_fft, win = 511, int(round(0.010 * rate))
    hop = int(round(0.005 * rate))
    k = torch.arange(win, dtype=torch.float64, device=wave.device)
    hann = 0.5 - 0.5 * torch.cos(2 * math.pi * k / win)
    left = (n_fft - win) // 2
    window = torch.zeros(n_fft, dtype=torch.float64, device=wave.device)
    window[left:left + win] = hann
    x = torch.nn.functional.pad(wave.float(), (n_fft // 2, n_fft // 2))
    frames = x.unfold(-1, n_fft, hop) * window.float()
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.log(power + 1e-6).transpose(-1, -2)


def inputs(pool, modality: List[str], idx: np.ndarray,
           crops: Dict[str, Tuple[np.ndarray, np.ndarray]], segments: int,
           frames_per_segment: int, input_size: int, rate: int,
           seconds: float, device) -> Dict[str, torch.Tensor]:
    """Model inputs {modality: (N, S, F, H, W, C)} of the raw samples
    ``idx`` with the given crops; sound (N, S, 1, 256, frames, 1)."""
    out = {}
    for m in modality:
        if m == "sound":
            wave = torch.from_numpy(pool.wave[idx]).to(device)
            valid = torch.from_numpy(pool.valid[idx]).to(device)
            spec = spectrogram(wave, rate, seconds) * valid[..., None, None]
            out[m] = spec[:, :, None, :, :, None]
            continue
        raw = torch.from_numpy(pool.frames[m][idx]).to(device).float()
        if m == "rgbdiff":
            raw = rgb_difference(raw)
        mean, std = ((FLOW_MEAN, FLOW_STD) if m == "flow"
                     else (IMAGENET_MEAN, IMAGENET_STD))
        crop, flip = crops[m]
        x = crop_resize(raw, torch.from_numpy(crop).to(device),
                        torch.from_numpy(flip).to(device), input_size,
                        mean, std, m == "flow")
        n, c, k = x.shape[0], x.shape[-1], STACKED[m]
        x = x.reshape(n, segments, frames_per_segment, k, input_size,
                      input_size, c).permute(0, 1, 2, 4, 5, 3, 6)
        out[m] = x.reshape(n, segments, frames_per_segment, input_size,
                           input_size, k * c)
    return out
