"""Device-side preprocessing (``adamml_tpu/ops/augment.py``).

The host decodes frames into a fixed-size uint8 canvas and samples a crop
rectangle and flip per sample; on the device one op crops, resizes, flips
and normalizes (``crop_resize_normalize``: on a card one hand-written
kernel, on the CPU ``plain_crop_resize``), forming the RGB-difference proxy
frames (``rgbdiff_from_frames``) and packing stacked frames into the
channels on the way. ``policy_stream`` builds the policy net's input from
the main-net visual stream.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .kernels import crop_resize as crop_resize_kernel


def policy_stream(x: torch.Tensor, size: int = 160,
                  stride: int = 2) -> torch.Tensor:
    """Policy-net input from the main-net visual stream (reference
    models/adamml.py:59-62): every ``stride``-th frame, bilinear downsample
    to ``size``.

    x: (N, S, F, H, W, C) -> (N, S, ceil(F/stride), size, size, C).

    ``jax.image.resize(method="linear")`` antialiases when it minifies, so
    the match is ``antialias=True`` (without it the result is off by O(1)).
    The resize runs in float32.
    """
    n, s, f, h, w, c = x.shape
    sub = x[:, :, ::stride]
    fp = sub.shape[2]
    t = sub.reshape(n * s * fp, h, w, c).permute(0, 3, 1, 2).float()
    t = F.interpolate(t.contiguous(), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return t.permute(0, 2, 3, 1).reshape(n, s, fp, size, size, c).to(x.dtype)


def resample_weights(input_size: int, output_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """Per-sample (N, output_size, input_size) float32 weights of
    ``jax.image.scale_and_translate(method="linear", antialias=True)`` along
    one axis (``jax/_src/image/scale.py::compute_weight_mat``, transposed):
    a triangle filter widened by max(1/scale, 1) when minifying, each
    output's weights normalised by their sum (zeroed when the sum is under
    1000 float32 eps), and zeroed where the sample centre falls outside
    [-0.5, input_size - 0.5]. So near a crop's edge the filter reads canvas
    pixels outside the crop rectangle, as the JAX function does.

    scale, translation: (N,) float32."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(output_size, dtype=torch.float32, device=dev)
    sample_f = ((out_pos[None, :, None] + 0.5) * inv_scale
                - translation[:, None, None] * inv_scale - 0.5)
    in_pos = torch.arange(input_size, dtype=torch.float32, device=dev)
    x = (sample_f - in_pos[None, None, :]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total,
                                                torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


def crop_resize_normalize(frames: torch.Tensor, crop_xywh: torch.Tensor,
                          flip: torch.Tensor, *, out_size: int,
                          mean: Optional[Sequence[float]],
                          std: Optional[Sequence[float]],
                          flow_channels: bool = False,
                          compute_dtype: torch.dtype = torch.float32,
                          cons: int = 1, rgbdiff: bool = False,
                          ncrops: int = 1) -> torch.Tensor:
    """Batched crop + resize + flip + normalize, on the frames' device.

    frames:    (Nc, T, H, W, C) uint8 canvas (frames at top-left, zero pad)
    crop_xywh: (N, 4) float32 crop rectangles in source pixel coords,
               N = Nc * ncrops: sample n crops canvas n // ncrops
    flip:      (N,) bool
    mean/std:  per-channel tuples, or None to skip normalization
    flow_channels: True when C == 2 (x, y flow pair): x inverts on flip
    cons:      frames packed into an output frame's channels, frame-major
    rgbdiff:   the frames are the differences of each group of cons + 1
               consecutive canvas frames (``rgbdiff_from_frames``)
    returns    (N, T_out, out_size, out_size, cons * C) compute_dtype, with
               T_out = T / cons (T / (cons + 1) with rgbdiff)

    A CUDA tensor goes to the hand-written kernel
    (``ops/kernels/crop_resize.py``), which reads the canvases once and
    writes this layout; a CPU tensor takes ``plain_crop_resize``.
    """
    if frames.is_cuda:
        return crop_resize_kernel.crop_resize(
            frames, crop_xywh.float().contiguous(), flip.contiguous(),
            out_size=out_size, mean=mean, std=std, flow=flow_channels,
            rgbdiff=rgbdiff, cons=cons, ncrops=ncrops,
            out_dtype=compute_dtype)
    return plain_crop_resize(
        frames, crop_xywh, flip, out_size=out_size, mean=mean, std=std,
        flow_channels=flow_channels, compute_dtype=compute_dtype, cons=cons,
        rgbdiff=rgbdiff, ncrops=ncrops)


def plain_crop_resize(frames: torch.Tensor, crop_xywh: torch.Tensor,
                      flip: torch.Tensor, *, out_size: int,
                      mean: Optional[Sequence[float]],
                      std: Optional[Sequence[float]],
                      flow_channels: bool = False,
                      compute_dtype: torch.dtype = torch.float32,
                      cons: int = 1, rgbdiff: bool = False,
                      ncrops: int = 1) -> torch.Tensor:
    """``crop_resize_normalize`` in plain PyTorch, on any device: the
    canvases repeated per crop, rgbdiff's frames, then the resize.

    The resize is ``jax.image.scale_and_translate`` (linear, antialiased)
    with scale out/crop and translation -origin*scale per axis, computed
    as two contractions with the per-sample weight matrices of
    ``resample_weights`` in float32 (TF32 must be off on the card for the
    result to match the CPU's).
    """
    if ncrops > 1:
        frames = frames.repeat_interleave(ncrops, dim=0)
    if rgbdiff:
        n, t = frames.shape[:2]
        g = cons + 1
        diffs = rgbdiff_from_frames(
            frames.reshape((n, t // g, g) + tuple(frames.shape[2:])))
        frames = diffs.reshape((n, t // g * cons) + tuple(frames.shape[2:]))
    n, t, h, w, c = frames.shape
    crop = crop_xywh.float()
    x0, y0, cw, ch = crop[:, 0], crop[:, 1], crop[:, 2], crop[:, 3]
    scale_y = out_size / ch
    scale_x = out_size / cw
    wy = resample_weights(h, out_size, scale_y, -y0 * scale_y)
    wx = resample_weights(w, out_size, scale_x, -x0 * scale_x)
    x = frames.float()
    x = torch.einsum("nthwc,nph->ntpwc", x, wy)
    out = torch.einsum("ntpwc,nqw->ntpqc", x, wx)
    flipped = out.flip(3)
    if flow_channels:
        # flow x-channels invert their pixel values when flipped
        # (reference utils/video_transforms.py:54-57)
        invert = torch.zeros(c, dtype=torch.bool, device=out.device)
        invert[0] = True
        flipped = torch.where(invert, 255.0 - flipped, flipped)
    out = torch.where(flip.to(out.device).view(n, 1, 1, 1, 1), flipped, out)
    if mean is not None:
        mean_t = torch.tensor(mean, dtype=torch.float32, device=out.device)
        std_t = torch.tensor(std, dtype=torch.float32, device=out.device)
        out = out / 255.0
        out = (out - mean_t) / std_t
    out = out.to(compute_dtype)
    if cons > 1:
        # (N, T_out * cons, h, w, c) -> (N, T_out, h, w, cons * c)
        out = out.reshape(n, t // cons, cons, out_size, out_size, c)
        out = out.permute(0, 1, 3, 4, 2, 5).reshape(
            n, t // cons, out_size, out_size, cons * c)
    return out


def rgbdiff_from_frames(frames: torch.Tensor) -> torch.Tensor:
    """RGB-difference proxy frames (reference utils/video_dataset.py:32-38):
    diff = (a - b + 255) * 255/510, floored to uint8 as the reference's
    numpy astype(np.uint8) truncates.

    frames: (..., K, H, W, C) uint8, K consecutive frames
    returns (..., K-1, H, W, C) uint8 diffs (frame[i+1] - frame[i])
    """
    a = frames[..., 1:, :, :, :].float()
    b = frames[..., :-1, :, :, :].float()
    diff = (a - b + 255.0) * (255.0 / 510.0)
    return torch.floor(diff).to(torch.uint8)
