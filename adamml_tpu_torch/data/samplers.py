"""Frame-index samplers (pure numpy; the port's copy of
``adamml_tpu/data/samplers.py``).

Behavioral twins of the reference samplers, which have many branches worth
enumerating (golden-index tests cover the deterministic ones):

  random_clip            reference utils/video_dataset.py:7-29
  sample_train_clip      reference utils/video_dataset.py:135-170
  sample_val_test_clip   reference utils/video_dataset.py:173-233

All return 1-based frame indices. The val/test uniform non-fixed path keeps
the reference's per-clip np.random.seed(i) reseeding quirk (reference
utils/video_dataset.py:224,228) so validation sets are reproducible across
implementations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def random_clip(video_frames: int, sampling_rate: int, frames_per_clip: int,
                fixed_offset: bool = False, start_frame_idx: int = 0,
                end_frame_idx: Optional[int] = None,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Dense clip: one start offset, then every `sampling_rate` frames,
    wrapped modulo video length (reference utils/video_dataset.py:7-29)."""
    rng = np.random if rng is None else rng
    highest = (video_frames - sampling_rate * frames_per_clip
               if end_frame_idx is None else end_frame_idx)
    if highest <= 0:
        offset = 0
    elif fixed_offset:
        offset = (video_frames - sampling_rate * frames_per_clip) // 2
    else:
        offset = int(rng.randint(start_frame_idx, highest))
    return np.asarray([(offset + i * sampling_rate) % video_frames
                       for i in range(frames_per_clip)], dtype=np.int64)


def sample_train_clip(video_length: int, num_consecutive_frames: int,
                      num_frames: int, sample_freq: int, dense_sampling: bool,
                      num_clips: int = 1,
                      rng: Optional[np.random.RandomState] = None
                      ) -> np.ndarray:
    """Training indices, 1-based (reference utils/video_dataset.py:135-170)."""
    rng = np.random if rng is None else rng
    max_frame_idx = max(1, video_length - num_consecutive_frames + 1)
    if dense_sampling:
        out = np.zeros((num_clips, num_frames), dtype=np.int64)
        if num_clips == 1:
            out[0] = random_clip(max_frame_idx, sample_freq, num_frames,
                                 False, rng=rng)
        else:
            max_start = max_frame_idx - sample_freq * num_frames
            per_segment = max_start // num_clips
            for i in range(num_clips):
                if per_segment <= 0:
                    out[i] = random_clip(max_frame_idx, sample_freq,
                                         num_frames, False, rng=rng)
                else:
                    out[i] = random_clip(max_frame_idx, sample_freq,
                                         num_frames, False,
                                         i * per_segment,
                                         (i + 1) * per_segment, rng=rng)
        frame_idx = out.flatten()
    else:  # uniform (TSN-style segments)
        total_frames = num_frames * sample_freq
        ave = max_frame_idx // num_frames
        if ave >= sample_freq:
            frame_idx = np.repeat(np.arange(num_frames) * ave, sample_freq)
            offsets = rng.choice(ave, sample_freq, replace=False)
            frame_idx = frame_idx + np.tile(offsets, num_frames)
        elif max_frame_idx < total_frames:
            frame_idx = rng.choice(max_frame_idx, total_frames)
        else:
            frame_idx = rng.choice(max_frame_idx, total_frames, replace=False)
        frame_idx = np.sort(frame_idx)
    return frame_idx + 1


def sample_val_test_clip(video_length: int, num_consecutive_frames: int,
                         num_frames: int, sample_freq: int,
                         dense_sampling: bool, fixed_offset: bool,
                         num_clips: int,
                         rng: Optional[np.random.RandomState] = None
                         ) -> np.ndarray:
    """Validation/test indices, 1-based (reference
    utils/video_dataset.py:173-233)."""
    rng = np.random if rng is None else rng
    max_frame_idx = max(1, video_length - num_consecutive_frames + 1)
    if dense_sampling:
        if fixed_offset:
            # evenly spaced clip starts (reference video_dataset.py:177-184)
            sample_pos = max(1, 1 + max_frame_idx - sample_freq * num_frames)
            starts = np.linspace(0, sample_pos - 1, num=num_clips, dtype=int)
            frame_idx = []
            for start in starts.tolist():
                frame_idx += [(i * sample_freq + start) % max_frame_idx
                              for i in range(num_frames)]
        else:
            frame_idx = []
            for _ in range(num_clips):
                frame_idx.extend(random_clip(max_frame_idx, sample_freq,
                                             num_frames, rng=rng).tolist())
        return np.asarray(frame_idx, dtype=np.int64) + 1

    # uniform sampling
    indices = []
    if fixed_offset:
        sample_offsets = list(range(-num_clips // 2 + 1, num_clips // 2 + 1))
        for off in sample_offsets:
            if max_frame_idx > num_frames:
                tick = max_frame_idx / float(num_frames)
                cur = min(max(off, -tick / 2.0), tick / 2.0 - 1e-4)
                frame_idx = np.asarray([int(tick / 2.0 + cur + tick * x)
                                        for x in range(num_frames)])
            else:
                # reference reseeds the GLOBAL rng per clip
                # (utils/video_dataset.py:205); a fresh RandomState with the
                # same seed draws identical values and is thread-safe
                quirk = np.random.RandomState(off - (-num_clips // 2 + 1))
                frame_idx = quirk.choice(max_frame_idx, num_frames)
            indices.extend(np.sort(frame_idx).tolist())
    else:
        for i in range(num_clips):
            total_frames = num_frames * sample_freq
            ave = max_frame_idx // num_frames
            if ave >= sample_freq:
                frame_idx = np.repeat(np.arange(num_frames) * ave, sample_freq)
                offsets = rng.choice(ave, sample_freq, replace=False)
                frame_idx = frame_idx + np.tile(offsets, num_frames)
            elif max_frame_idx < total_frames:
                # per-clip np.random.seed(i) quirk (reference
                # utils/video_dataset.py:224,228) as a thread-safe RandomState
                frame_idx = np.random.RandomState(i).choice(
                    max_frame_idx, total_frames)
            else:
                frame_idx = np.random.RandomState(i).choice(
                    max_frame_idx, total_frames, replace=False)
            indices.extend(np.sort(frame_idx).tolist())
    return np.asarray(indices, dtype=np.int64) + 1
