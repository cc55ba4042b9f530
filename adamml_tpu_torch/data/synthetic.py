"""Synthetic multi-modal dataset for tests and benchmarks (the port's copy
of ``adamml_tpu/data/synthetic.py``).

Mirrors the MultiVideoDataset payload contract exactly but generates
deterministic pseudo-random frames/waveforms per index -- no disk, no
decode -- so end-to-end training, sharding, and benchmark paths run without
Kinetics-Sounds on hand.

Frame COUNTS come from the real samplers (samplers.py), so payload shapes
track the real dataset for every (dense_sampling, frames_per_group,
fixed_offset, num_clips) combination -- dense-stride and uniform configs are
exercised by synthetic e2e runs exactly as they would be on disk data.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..configs.config import NUM_CONSECUTIVE_FRAMES
from .samplers import sample_train_clip, sample_val_test_clip

# fixed virtual video length; long enough that dense sampling at the default
# stride never wraps for practical (groups, frames_per_group)
_VIDEO_LENGTH = 300


class SyntheticVideoDataset:
    def __init__(self, modality: Sequence[str], length: int = 256,
                 num_groups: int = 8, frames_per_group: int = 1,
                 num_clips: int = 1, num_classes: int = 31,
                 canvas_size: Tuple[int, int] = (256, 464),
                 audio_length: float = 1.28, resampling_rate: float = 24000,
                 is_train: bool = True, dense_sampling: bool = True,
                 fixed_offset: bool = True, seed: int = 0) -> None:
        self.modality = list(modality)
        self.length = length
        self.num_frames = num_groups
        self.sample_freq = frames_per_group
        self.num_clips = num_clips
        self.num_classes = num_classes
        self.canvas_size = tuple(canvas_size)
        self.audio_length = audio_length
        self.resampling_rate = resampling_rate
        self.is_train = is_train
        self.dense_sampling = dense_sampling
        self.fixed_offset = fixed_offset
        self.seed = seed
        self.multi_label = False
        self.num_consecutive_frames = max(
            NUM_CONSECUTIVE_FRAMES[m] for m in self.modality)

    def __len__(self) -> int:
        return self.length

    def _num_indices(self, rng: Optional[np.random.RandomState]) -> int:
        """Frames per sample, via the real samplers (count is config-static)."""
        if self.is_train:
            idx = sample_train_clip(_VIDEO_LENGTH,
                                    self.num_consecutive_frames,
                                    self.num_frames, self.sample_freq,
                                    self.dense_sampling, self.num_clips,
                                    rng=rng)
        else:
            idx = sample_val_test_clip(_VIDEO_LENGTH,
                                       self.num_consecutive_frames,
                                       self.num_frames, self.sample_freq,
                                       self.dense_sampling, self.fixed_offset,
                                       self.num_clips, rng=rng)
        return int(len(idx))

    def get_sample(self, index: int,
                   rng: Optional[np.random.RandomState] = None):
        content = np.random.RandomState(
            (self.seed * 1000003 + index) % (2**31))
        t = self._num_indices(rng if rng is not None
                              else np.random.RandomState(index))
        ch, cw = self.canvas_size
        out: Dict[str, Dict[str, np.ndarray]] = {}
        # all modalities share a plausible true size within the canvas
        h = min(256, ch)
        w = int(content.randint(h, cw + 1)) if cw > h else cw
        hw = np.asarray([h, w], np.int32)
        for m in self.modality:
            if m == "sound":
                l = int(round(self.resampling_rate * self.audio_length))
                out[m] = {
                    "wave": content.randn(self.num_clips, l).astype(
                        np.float32) * 0.1,
                    "valid": np.ones((self.num_clips,), np.float32)}
            elif m == "rgb":
                frames = np.zeros((t, ch, cw, 3), np.uint8)
                frames[:, :h, :w] = content.randint(0, 256, (t, h, w, 3),
                                                    dtype=np.uint8)
                out[m] = {"frames": frames, "hw": hw.copy()}
            elif m == "flow":
                k = NUM_CONSECUTIVE_FRAMES["flow"]
                frames = np.zeros((t * k, ch, cw, 2), np.uint8)
                frames[:, :h, :w] = content.randint(0, 256, (t * k, h, w, 2),
                                                    dtype=np.uint8)
                out[m] = {"frames": frames, "hw": hw.copy()}
            else:  # rgbdiff raw consecutive frames
                k = NUM_CONSECUTIVE_FRAMES["rgbdiff"] + 1
                frames = np.zeros((t * k, ch, cw, 3), np.uint8)
                frames[:, :h, :w] = content.randint(0, 256, (t * k, h, w, 3),
                                                    dtype=np.uint8)
                out[m] = {"frames": frames, "hw": hw.copy()}
        label = int(content.randint(self.num_classes))
        return out, label

    def __getitem__(self, index: int):
        return self.get_sample(index)
