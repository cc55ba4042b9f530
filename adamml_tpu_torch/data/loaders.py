"""Host-side raw loading: JPEG frames into fixed canvases, WAV windows (the
port's copy of ``adamml_tpu/data/loaders.py``).

Decode is the only host CPU work of the pipeline (geometry, normalization
and the spectrogram run on the card, ``data/device_pipeline.py``). Frames
land in a fixed-size uint8 canvas so batch shapes stay static; the true
(h, w) rides along for the device crop.

Image loading retries 10x like the reference (reference
utils/video_dataset.py:51-66). Audio mirrors reference load_sound
(utils/video_dataset.py:94-132): center frame -> seconds, an audio_length
window with edge clamping, tiling of short clips; a missing wav yields a
zero window + valid=0 so the device produces the reference's all-zero
spectrogram image (utils/video_dataset.py:102-103). WAVs are read with
scipy.io.wavfile and scaled to [-1, 1] like librosa.load does for PCM.

``decode_counts`` counts the frames each decoder decoded in this process
("native": ``data/native_decode.py``, "pil": ``_safe_load_image``), so a
run can show which decoder its frames went through.
"""

from __future__ import annotations

import os
import threading
from typing import Tuple

import numpy as np

from .records import VideoRecord

decode_counts = {"native": 0, "pil": 0}
_counts_lock = threading.Lock()


def count_decoded(decoder: str, n: int = 1) -> None:
    with _counts_lock:
        decode_counts[decoder] += n


def _safe_load_image(path: str) -> np.ndarray:
    from PIL import Image

    for _ in range(10):
        try:
            with Image.open(path) as img:
                arr = np.asarray(img.convert(img.mode), dtype=np.uint8)
        except Exception as e:  # noqa: BLE001 - retry on any decode error
            print(f"[Will try load again] error loading image: {path}, "
                  f"error: {e}", flush=True)
            continue
        count_decoded("pil")
        return arr
    raise ValueError(f"[Fail 10 times] error loading image: {path}")


def load_frame_rgb(path: str) -> np.ndarray:
    arr = _safe_load_image(path)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[..., :3]


def load_frame_gray(path: str) -> np.ndarray:
    arr = _safe_load_image(path)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr


def place_in_canvas(frame: np.ndarray, canvas: np.ndarray) -> Tuple[int, int]:
    """Copy frame into canvas[:h, :w]; returns the true (h, w). Oversized
    frames are fitted with a PIL bilinear resize (keeps shapes static for
    any source material)."""
    ch, cw = canvas.shape[0], canvas.shape[1]
    h, w = frame.shape[0], frame.shape[1]
    if h > ch or w > cw:
        from PIL import Image

        scale = min(ch / h, cw / w)
        nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
        img = Image.fromarray(frame).resize((nw, nh), Image.BILINEAR)
        frame = np.asarray(img, dtype=np.uint8)
        h, w = nh, nw
    if frame.ndim == 2:
        frame = frame[..., None]
    canvas[:h, :w, :frame.shape[-1]] = frame
    return h, w


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """(mono float32 samples in [-1, 1], sample rate). Integer samples are
    scaled before the channels are averaged: the JAX package averages
    first, which turns int16 into float64 and skips its scaling, so its
    stereo windows come out 32768 times too loud (ROADMAP C)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, int(sr)


def extract_audio_window(samples: np.ndarray, record: VideoRecord,
                         center_idx: int, fps: float, audio_length: float,
                         resampling_rate: float) -> np.ndarray:
    """Fixed-length window around a frame (reference
    utils/video_dataset.py:97-123). Duration is computed with the DECLARED
    resampling rate like the reference, by design."""
    required = int(round(resampling_rate * audio_length))
    centre_sec = (record.start_frame + center_idx) / fps
    left_sec = centre_sec - audio_length / 2.0
    right_sec = centre_sec + audio_length / 2.0
    duration = samples.shape[0] / float(resampling_rate)
    left = int(round(left_sec * resampling_rate))
    right = int(round(right_sec * resampling_rate))
    if left_sec < 0:
        win = samples[:required]
    elif right_sec > duration:
        win = samples[-required:]
    else:
        win = samples[left:right]
    if len(win) < required:
        if len(win) == 0:
            return np.zeros((required,), np.float32)
        mult = required / len(win)
        win = np.tile(win, int(mult + 0.5) + 1)[:required]
    return win[:required].astype(np.float32)


def load_sound_window(data_dir: str, record: VideoRecord, center_idx: int,
                      fps: float, audio_length: float,
                      resampling_rate: float) -> Tuple[np.ndarray, bool]:
    """(waveform, valid). Missing file -> zeros + valid=False (reference
    utils/video_dataset.py:102-103)."""
    required = int(round(resampling_rate * audio_length))
    path = os.path.join(data_dir, record.path)
    if not os.path.exists(path):
        return np.zeros((required,), np.float32), False
    samples, _sr = read_wav(path)
    return extract_audio_window(samples, record, center_idx, fps,
                                audio_length, resampling_rate), True
