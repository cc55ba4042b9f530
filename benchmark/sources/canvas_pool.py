"""canvas_pool: a few batches of decoded clips, made once from the seed at
set-up, that a long dataset serves over and over (dataset index i reads
pool sample i mod the pool's size), so that no random generation and no
decoding runs inside the measured window.

A sample has the payload layout of the program's synthetic and decoded
datasets (``adamml_tpu_torch/data/synthetic.py``): per visual modality a
uint8 canvas of the loader's canvas size (256 x 464), the picture in its
top-left 256 x w corner (w uniform in [256, 464], as a 256-pixel-high
video of any aspect from 1:1 to 16:9 lands there) and zeros beyond, with
its true (h, w); rgb takes one frame a sampled index, flow five
two-channel frames, rgbdiff six consecutive rgb frames; per segment a
24 kHz waveform of N(0, 0.1^2) samples and a valid flag. The bytes are
drawn on the device in one call a modality and copied to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

FRAMES_PER_INDEX = {"rgb": 1, "flow": 5, "rgbdiff": 6}
CHANNELS = {"rgb": 3, "flow": 2, "rgbdiff": 3}


@dataclasses.dataclass
class Pool:
    size: int
    frames: Dict[str, np.ndarray]   # (P, T, H, W, C) uint8
    hw: np.ndarray                  # (P, 2) int32
    wave: np.ndarray                # (P, S, L) float32
    valid: np.ndarray               # (P, S) float32
    labels: np.ndarray              # (P,) int64


def make(modality: Sequence[str], *, samples: int, segments: int,
         frames_per_segment: int, canvas, wave_samples: int,
         num_classes: int, seed: int, device) -> Pool:
    host = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    ch, cw = canvas
    h = min(256, ch)
    widths = host.integers(h, cw + 1, size=samples)
    hw = np.stack([np.full(samples, h), widths], 1).astype(np.int32)
    frames = {}
    for m in modality:
        if m == "sound":
            continue
        t = segments * frames_per_segment * FRAMES_PER_INDEX[m]
        raw = torch.randint(0, 256, (samples, t, ch, cw, CHANNELS[m]),
                            generator=gen, dtype=torch.uint8, device=device)
        arr = raw.cpu().numpy()
        del raw
        arr[:, :, h:] = 0
        for i, w in enumerate(widths):
            arr[i, :, :, w:] = 0
        frames[m] = arr
    wave = (0.1 * torch.randn((samples, segments, wave_samples),
                              generator=gen, device=device)).cpu().numpy()
    return Pool(size=samples, frames=frames, hw=hw, wave=wave,
                valid=np.ones((samples, segments), np.float32),
                labels=host.integers(0, num_classes, size=samples))


class Dataset:
    """``length`` samples over the pool, in the program's dataset interface
    (``get_sample(index, rng)`` -> ({modality: payload}, label))."""

    def __init__(self, pool: Pool, modality: Sequence[str], length: int):
        self.pool, self.modality, self.length = pool, list(modality), length
        self.multi_label = False

    def __len__(self) -> int:
        return self.length

    def get_sample(self, index: int, rng=None):
        i = int(index) % self.pool.size
        out = {}
        for m in self.modality:
            if m == "sound":
                out[m] = {"wave": self.pool.wave[i],
                          "valid": self.pool.valid[i]}
            else:
                out[m] = {"frames": self.pool.frames[m][i],
                          "hw": self.pool.hw[i]}
        return out, int(self.pool.labels[i])

    def __getitem__(self, index: int):
        return self.get_sample(index)
