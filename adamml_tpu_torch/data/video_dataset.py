"""Map-style multi-modal datasets over frame folders (the port's copy of
``adamml_tpu/data/video_dataset.py``: the same payloads, byte for byte,
through the same decoder).

Capability twins of the reference datasets (reference
utils/video_dataset.py:253-522) returning numpy payloads shaped for the
device preprocessing pipeline instead of PIL images:

  rgb     -> uint8 (T, Hc, Wc, 3), T = num_clips * num_frames
  flow    -> uint8 (T*5, Hc, Wc, 2), x/y pair per channel
  rgbdiff -> uint8 (T*6, Hc, Wc, 3) raw consecutive RGB; the diffs are
             computed on the card (ops.augment.rgbdiff_from_frames)
  sound   -> float32 (num_clips, L) waveform windows + valid mask

The core MultiVideoDataset invariant holds: frame indices are sampled ONCE
(using the max num_consecutive_frames across modalities) and shared by all
modalities (reference utils/video_dataset.py:498-519), and every child is
indexed by the first child's row, so the lists must align row for row.

The reference's consecutive-frame clamp bug (clamping an absolute frame id
to record.num_frames, reference utils/video_dataset.py:406 -- wrong whenever
start_frame != 1) is fixed here by clamping to record.end_frame, as in the
JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs.config import NUM_CONSECUTIVE_FRAMES
from .loaders import (load_frame_gray, load_frame_rgb, load_sound_window,
                      place_in_canvas)
from .native_decode import decode_jpeg_batch, native_available
from .records import VideoRecord, parse_list_file
from .samplers import sample_train_clip, sample_val_test_clip


def _sample(ds, record: VideoRecord,
            rng: Optional[np.random.RandomState]) -> np.ndarray:
    if ds.is_train:
        return sample_train_clip(record.num_frames, ds.num_consecutive_frames,
                                 ds.num_frames, ds.sample_freq,
                                 ds.dense_sampling, ds.num_clips, rng=rng)
    return sample_val_test_clip(record.num_frames, ds.num_consecutive_frames,
                                ds.num_frames, ds.sample_freq,
                                ds.dense_sampling, ds.fixed_offset,
                                ds.num_clips, rng=rng)


class VideoDataset:
    """Single-modality dataset (reference utils/video_dataset.py:253-428)."""

    def __init__(self, root_path: str, list_file: str, num_groups: int = 8,
                 frames_per_group: int = 1, num_clips: int = 1,
                 modality: str = "rgb", dense_sampling: bool = False,
                 fixed_offset: bool = True, image_tmpl: str = "{:05d}.jpg",
                 is_train: bool = True, test_mode: bool = False,
                 separator: str = " ", filter_video: int = 0,
                 num_classes: Optional[int] = None, fps: float = 29.97,
                 audio_length: float = 1.28, resampling_rate: float = 24000,
                 canvas_size: Tuple[int, int] = (256, 464),
                 use_native_decoder: bool = True,
                 decode_threads: int = 1) -> None:
        if modality not in ("flow", "rgb", "rgbdiff", "sound"):
            raise ValueError(f"bad modality {modality!r}")
        self.root_path = root_path
        self.num_frames = num_groups
        self.sample_freq = frames_per_group
        self.num_clips = num_clips
        self.modality = modality
        self.dense_sampling = dense_sampling
        self.fixed_offset = fixed_offset
        self.image_tmpl = image_tmpl
        self.is_train = is_train
        self.test_mode = test_mode
        self.fps = fps
        self.audio_length = audio_length
        self.resampling_rate = resampling_rate
        self.canvas_size = tuple(canvas_size)
        self.use_native_decoder = use_native_decoder
        # within-sample decode threads of the native decoder (it releases
        # the GIL); the loader's thread pool already decodes across samples
        self.decode_threads = max(1, decode_threads)
        self.num_consecutive_frames = NUM_CONSECUTIVE_FRAMES[modality]
        self.num_classes = num_classes
        self.video_list, self.multi_label = parse_list_file(
            list_file if os.path.isabs(list_file)
            else os.path.join(root_path, list_file),
            separator=separator, filter_video=filter_video,
            test_mode=test_mode, modality=modality)

    def __len__(self) -> int:
        return len(self.video_list)

    def sample_indices(self, record: VideoRecord,
                       rng: Optional[np.random.RandomState] = None
                       ) -> np.ndarray:
        return _sample(self, record, rng)

    # -- raw loading ------------------------------------------------------

    def _frame_path(self, record: VideoRecord, abs_idx: int,
                    prefix: str = "") -> str:
        return os.path.join(self.root_path, record.path,
                            prefix + self.image_tmpl.format(abs_idx))

    def _consecutive_ids(self, record: VideoRecord, seg_ind: int,
                         count: int) -> List[int]:
        return [min(int(seg_ind) + record.start_frame - 1 + i,
                    record.end_frame) for i in range(count)]

    def _sound(self, record: VideoRecord, indices) -> Dict[str, np.ndarray]:
        per_clip = np.asarray(indices).reshape(self.num_clips,
                                               self.num_frames)
        length = int(round(self.resampling_rate * self.audio_length))
        waves = np.zeros((self.num_clips, length), np.float32)
        valid = np.zeros((self.num_clips,), np.float32)
        f = self.num_frames
        for c, idx in enumerate(per_clip):
            # the mean of the two middle indices when f is even, clamped to
            # the record's length (reference utils/video_dataset.py:116-122)
            center = (int(idx[f // 2 - 1] + idx[f // 2]) // 2
                      if f % 2 == 0 else int(idx[f // 2]))
            center = min(record.num_frames, center)
            waves[c], ok = load_sound_window(
                self.root_path, record, center, self.fps, self.audio_length,
                self.resampling_rate)
            valid[c] = float(ok)
        return {"wave": waves, "valid": valid}

    def _rgb(self, record: VideoRecord, indices) -> Dict[str, np.ndarray]:
        ch, cw = self.canvas_size
        frames = np.zeros((len(indices), ch, cw, 3), np.uint8)
        hw = np.zeros((2,), np.int32)
        paths = [self._frame_path(
            record, self._consecutive_ids(record, seg_ind, 1)[0])
            for seg_ind in indices]
        done = np.zeros((len(paths),), bool)
        if self.use_native_decoder and native_available():
            out_hw = decode_jpeg_batch(paths, frames,
                                       n_threads=self.decode_threads)
            done = out_hw[:, 0] > 0
            if done.any():
                hw[:] = out_hw[done][0]
        for t, path in enumerate(paths):
            if not done[t]:  # PIL, with its 10 tries, per frame not decoded
                hw[:] = place_in_canvas(load_frame_rgb(path), frames[t])
        return {"frames": frames, "hw": hw}

    def _flow(self, record: VideoRecord, indices) -> Dict[str, np.ndarray]:
        ch, cw = self.canvas_size
        k = self.num_consecutive_frames
        frames = np.zeros((len(indices) * k, ch, cw, 2), np.uint8)
        hw = np.zeros((2,), np.int32)
        t = 0
        for seg_ind in indices:
            for abs_id in self._consecutive_ids(record, seg_ind, k):
                x = load_frame_gray(self._frame_path(record, abs_id, "x_"))
                y = load_frame_gray(self._frame_path(record, abs_id, "y_"))
                hw[:] = place_in_canvas(np.stack([x, y], axis=-1), frames[t])
                t += 1
        return {"frames": frames, "hw": hw}

    def _rgbdiff(self, record: VideoRecord, indices) -> Dict[str, np.ndarray]:
        """k = NUM_CONSECUTIVE_FRAMES + 1 raw consecutive frames per sampled
        position through a per-sample cache; the card computes the diffs
        (reference utils/video_dataset.py:75-84)."""
        ch, cw = self.canvas_size
        k = self.num_consecutive_frames + 1
        frames = np.zeros((len(indices) * k, ch, cw, 3), np.uint8)
        hw = np.zeros((2,), np.int32)
        cache: Dict[int, np.ndarray] = {}
        t = 0
        for seg_ind in indices:
            for abs_id in self._consecutive_ids(record, seg_ind, k):
                if abs_id not in cache:
                    cache[abs_id] = load_frame_rgb(
                        self._frame_path(record, abs_id))
                hw[:] = place_in_canvas(cache[abs_id], frames[t])
                t += 1
        return {"frames": frames, "hw": hw}

    def get_data(self, record: VideoRecord, indices: np.ndarray
                 ) -> Dict[str, np.ndarray]:
        return {"sound": self._sound, "rgb": self._rgb, "flow": self._flow,
                "rgbdiff": self._rgbdiff}[self.modality](record, indices)

    def get_label(self, record: VideoRecord):
        if self.test_mode:
            return record.video_id
        if not self.multi_label:
            return int(record.label)
        onehot = np.zeros((self.num_classes,), np.float32)
        for x in record.label:
            onehot[int(x)] = 1.0
        return onehot

    def get_sample(self, index: int,
                   rng: Optional[np.random.RandomState] = None):
        """Fetch one sample, drawing frame indices from ``rng``. The loader
        passes a per-(seed, epoch, index) RandomState, so sampling is
        deterministic and thread-safe; bare __getitem__ falls back to the
        global np.random (the reference's single-threaded behaviour)."""
        record = self.video_list[index]
        indices = self.sample_indices(record, rng=rng)
        return self.get_data(record, indices), self.get_label(record)

    def __getitem__(self, index: int):
        return self.get_sample(index)


class MultiVideoDataset:
    """Aligned multi-modal dataset (reference utils/video_dataset.py:431-522).

    One child VideoDataset per modality; indices sampled once per sample
    with the MAX consecutive-frame count and shared across modalities."""

    def __init__(self, root_paths: Sequence[str], list_file: str,
                 modality: Sequence[str], **kwargs) -> None:
        if len(root_paths) < len(modality):
            raise ValueError(f"{len(modality)} modalities need as many "
                             f"--datadir roots, got {list(root_paths)}")
        self.modality = list(modality)
        self.children = [
            VideoDataset(root_paths[i], list_file, modality=m, **kwargs)
            for i, m in enumerate(modality)]
        first = self.children[0]
        self.video_list = first.video_list
        self.num_consecutive_frames = max(
            c.num_consecutive_frames for c in self.children)
        self.is_train = first.is_train
        self.num_frames = first.num_frames
        self.sample_freq = first.sample_freq
        self.dense_sampling = first.dense_sampling
        self.num_clips = first.num_clips
        self.fixed_offset = first.fixed_offset
        self.multi_label = first.multi_label

    def __len__(self) -> int:
        return len(self.video_list)

    def sample_indices(self, record: VideoRecord,
                       rng: Optional[np.random.RandomState] = None
                       ) -> np.ndarray:
        return _sample(self, record, rng)

    def get_sample(self, index: int,
                   rng: Optional[np.random.RandomState] = None):
        record = self.video_list[index]
        indices = self.sample_indices(record, rng=rng)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        label = None
        for m, child in zip(self.modality, self.children):
            rec = child.video_list[index]
            out[m] = child.get_data(rec, indices)
            label = child.get_label(rec)  # label from each; last wins == same
        return out, label

    def __getitem__(self, index: int):
        return self.get_sample(index)
