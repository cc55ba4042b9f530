"""Host batch -> model inputs, on the device
(``adamml_tpu/data/device_pipeline.py``).

The loader hands its batch over already in page-locked memory where a card
is present (``data/dataflow.py``); each array goes to the device on the
consuming thread in one ``non_blocking`` copy (``to_device``), then:

  rgb     (N, T, Hc, Wc, 3)    -> crop/resize/flip/normalize -> (N,S,F,h,w,3)
  flow    (N, T*5, Hc, Wc, 2)  -> same + x-inversion on flip -> (N,S,F,h,w,10)
  rgbdiff (N, T*6, Hc, Wc, 3)  -> on-device diffs then same  -> (N,S,F,h,w,15)
  sound   (N, S, L) waveforms  -> batched log-power STFT      -> (N,S,1,256,256,1)
          zeroed where the wav was missing (reference
          utils/video_dataset.py:102-103 zero-image fallback)

Each visual modality is one ``crop_resize_normalize`` call, which on a card
is one kernel launch from the canvases to the packed layout.
ImageNet mean/std for rgb/rgbdiff, [0.5]/[mean std] for flow (repeated over
the packed channels), and no normalization for sound.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from ..configs.config import modality_mean, modality_std
from ..models.model_builder import compute_dtype
from ..ops.augment import crop_resize_normalize
from ..ops.spectrogram import SpectrogramConfig, log_power_spectrogram
from ..utils.profiling import counted, span


def _mean_std(modality: str, skip: bool, mean_override, std_override,
              channels: int):
    if skip:
        return None, None
    mean = tuple(mean_override) if mean_override else modality_mean(modality)
    std = tuple(std_override) if std_override else modality_std(modality)
    reps = channels // len(mean)
    return tuple(mean) * reps, tuple(std) * reps


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on the CPU the array itself; to a card
    one ``non_blocking`` copy. An array that the loader assembled in
    page-locked memory (as ``Tensor.numpy()`` made it) is copied straight
    from the tensor behind it (``data.h2d.direct``): the copy reads torch's
    own tensor, so its caching host allocator orders any later reuse of
    that memory after the copy. Any other array is first copied into
    pinned memory here (``data.h2d.staged``). Runs in the span
    ``data.h2d`` (utils/profiling.py)."""
    with span("data.h2d"):
        if device.type == "cpu":
            return torch.from_numpy(np.ascontiguousarray(x))
        src = _pinned_tensor(x)
        if src is not None:
            with counted("data.h2d.direct"):
                return src.to(device, non_blocking=True)
        with counted("data.h2d.staged"):
            t = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
            return t.to(device, non_blocking=True)


def _pinned_tensor(x: np.ndarray):
    """The page-locked tensor whose memory ``x`` is, whole, or None."""
    t = x.base
    if (isinstance(t, torch.Tensor) and tuple(t.shape) == x.shape
            and t.is_contiguous() and x.flags.c_contiguous
            and t.data_ptr() == x.__array_interface__["data"][0]
            and t.is_pinned()):
        return t
    return None


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
            crops = 1
            if crop.dim() == 3:  # oversample: fold crops into the batch
                crops = ncrops
                if crop.shape[1] != ncrops:
                    raise ValueError(f"{m}: {crop.shape[1]} crop rects vs "
                                     f"num_crops={ncrops}")
                crop = crop.reshape(-1, 4)
                flip = flip.reshape(-1)
            cons = {"rgb": 1, "flow": 5, "rgbdiff": 5}[m]
            base_c = frames.shape[-1]
            mean, std = _mean_std(m, dcfg.skip_normalization, dcfg.mean,
                                  dcfg.std, base_c)
            # (N, S*F, h, w, cons*c), with rgbdiff's (N, S*F*6, ...) canvas
            # frames differenced on the way
            out = crop_resize_normalize(
                frames, crop, flip, out_size=out_size, mean=mean, std=std,
                flow_channels=(m == "flow"), compute_dtype=dtype, cons=cons,
                rgbdiff=(m == "rgbdiff"), ncrops=crops)
            out = out.reshape(out.shape[0], num_segments, groups, out_size,
                              out_size, cons * base_c)
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
