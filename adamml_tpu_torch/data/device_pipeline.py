"""Host batch -> model inputs, on the device
(``adamml_tpu/data/device_pipeline.py``).

The loader's numpy batch is pinned and copied to the device on the
consuming thread (``non_blocking`` when the device is a card), then:

  rgb     (N, T, Hc, Wc, 3)    -> crop/resize/flip/normalize -> (N,S,F,h,w,3)
  flow    (N, T*5, Hc, Wc, 2)  -> same + x-inversion on flip -> (N,S,F,h,w,10)
  rgbdiff (N, T*6, Hc, Wc, 3)  -> on-device diffs then same  -> (N,S,F,h,w,15)
  sound   (N, S, L) waveforms  -> batched log-power STFT      -> (N,S,1,256,256,1)
          zeroed where the wav was missing (reference
          utils/video_dataset.py:102-103 zero-image fallback)

ImageNet mean/std for rgb/rgbdiff, [0.5]/[mean std] for flow (repeated over
the packed channels), and no normalization for sound.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from ..configs.config import modality_mean, modality_std
from ..models.model_builder import compute_dtype
from ..ops.augment import crop_resize_normalize, rgbdiff_from_frames
from ..ops.spectrogram import SpectrogramConfig, log_power_spectrogram
from ..utils.profiling import span


def _mean_std(modality: str, skip: bool, mean_override, std_override,
              channels: int):
    if skip:
        return None, None
    mean = tuple(mean_override) if mean_override else modality_mean(modality)
    std = tuple(std_override) if std_override else modality_std(modality)
    reps = channels // len(mean)
    return tuple(mean) * reps, tuple(std) * reps


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory with a
    non-blocking copy to a card, as it is on the CPU. Runs in the span
    ``data.h2d`` (utils/profiling.py)."""
    with span("data.h2d"):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)


def make_batch_preprocessor(cfg, *, train: bool, num_segments: int,
                            device: Union[str, torch.device]) -> Callable:
    """Returns fn(host_batch) -> (inputs list, target), on ``device``."""
    device = torch.device(device)
    mcfg, dcfg = cfg.model, cfg.data
    modality = list(mcfg.modality)
    out_size = dcfg.input_size
    dtype = compute_dtype(cfg)
    groups = mcfg.groups
    spec_cfg = SpectrogramConfig(
        resampling_rate=int(dcfg.resampling_rate),
        audio_length=dcfg.audio_length)
    # Multi-crop oversample eval: (N, C, 4) crop rectangles fold into the
    # batch axis crop-major per sample, so every modality contributes
    # (N*C, ...) rows and the eval step averages logits over the C crops
    # (reference GroupOverSample, utils/video_transforms.py:121-178). The
    # crop count comes from the config, which the eval step reshapes by.
    ncrops = 1 if train else max(1, int(cfg.data.num_crops))

    def preprocess(batch: Dict) -> Tuple[List[torch.Tensor], torch.Tensor]:
        inputs: List[torch.Tensor] = []
        for m in modality:
            if m == "sound":
                wave = to_device(batch["sound_wave"], device)    # (N, S, L)
                valid = to_device(batch["sound_valid"], device)  # (N, S)
                spec = log_power_spectrogram(wave, spec_cfg)     # (N,S,fh,fw)
                spec = spec * valid[..., None, None]
                spec = spec[:, :, None, :, :, None]              # (N,S,1,fh,fw,1)
                if ncrops > 1:  # sound has no spatial crops: repeat rows
                    spec = spec.repeat_interleave(ncrops, dim=0)
                inputs.append(spec.to(dtype))
                continue

            frames = to_device(batch[f"{m}_frames"], device)
            crop = to_device(batch[f"{m}_crop"], device)
            flip = to_device(batch[f"{m}_flip"], device)
            if crop.dim() == 3:  # oversample: fold crops into the batch
                if crop.shape[1] != ncrops:
                    raise ValueError(f"{m}: {crop.shape[1]} crop rects vs "
                                     f"num_crops={ncrops}")
                frames = frames.repeat_interleave(ncrops, dim=0)
                crop = crop.reshape(-1, 4)
                flip = flip.reshape(-1)
            n = frames.shape[0]
            if m == "rgbdiff":
                # (N, P*6, Hc, Wc, 3) -> diffs (N, P*5, Hc, Wc, 3)
                p = frames.shape[1] // 6
                frames = frames.reshape((n, p, 6) + tuple(frames.shape[2:]))
                frames = rgbdiff_from_frames(frames)
                frames = frames.reshape((n, p * 5) + tuple(frames.shape[3:]))
            cons = {"rgb": 1, "flow": 5, "rgbdiff": 5}[m]
            base_c = frames.shape[-1]
            mean, std = _mean_std(m, dcfg.skip_normalization, dcfg.mean,
                                  dcfg.std, base_c)
            out = crop_resize_normalize(
                frames, crop, flip, out_size=out_size, mean=mean, std=std,
                flow_channels=(m == "flow"), compute_dtype=dtype)
            # (N, S*F*cons, h, w, c) -> (N, S, F, h, w, cons*c)
            out = out.reshape(n, num_segments, groups, cons, out_size,
                              out_size, base_c)
            out = out.permute(0, 1, 2, 4, 5, 3, 6)
            out = out.reshape(n, num_segments, groups, out_size, out_size,
                              cons * base_c)
            inputs.append(out)
        return inputs, to_device(batch["target"], device)

    return preprocess


def make_unimodal_preprocessor(cfg, *, train: bool, num_clips: int = 1,
                               device: Union[str, torch.device]
                               ) -> Callable:
    """Unimodal variant: returns fn(host_batch) -> (single input, target).

    Clips fold into the frame axis, so multi-clip eval gets the reference's
    frame-averaged logits: visual -> (N, clips*F, h, w, C), sound ->
    (N, clips, fh, fw, 1) (each clip one spectrogram "frame")."""
    multi = make_batch_preprocessor(cfg, train=train, num_segments=num_clips,
                                    device=device)

    def preprocess(batch):
        inputs, target = multi(batch)
        x = inputs[0]
        n, s, f = x.shape[0], x.shape[1], x.shape[2]
        return x.reshape((n, s * f) + tuple(x.shape[3:])), target

    return preprocess
