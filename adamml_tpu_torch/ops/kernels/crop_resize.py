"""Crop, resize, flip, normalize and rgbdiff of the loader's uint8 canvases
as one hand-written CUDA kernel (``csrc/crop_resize.cu``), writing the
model's input layout.

    frames (Nc, T_in, H, W, C) uint8  ->  (Nc * ncrops, T_out, h, w, cons * C)

Output frame t packs ``cons`` resized frames into its channels, frame-major:
canvas frames t * cons + k, or with ``rgbdiff`` the differences of canvas
frames t * (cons + 1) + k + 1 and t * (cons + 1) + k. Sample n reads canvas
n // ncrops. The function is ``ops/augment.py``'s plain path (its
``plain_crop_resize``), which a CPU tensor takes and the card tests hold the
kernel to.

``axis_taps`` is the kernel's tap rule along one axis written in PyTorch
(the band of nonzero weights of each output, its total, and the candidates
the kernel evaluates); ``band_weights`` turns it into the dense matrix of
weights the kernel applies. The CPU tests hold that matrix to
``augment.resample_weights``', and the card tests hold the kernel's own
weights, read through impulse canvases, to it bit for bit. ``work`` counts
the least bytes a launch moves, for the kernel's bound; ``plan`` is the
launch's plan, which the C entry takes as it is.

The kernel replaces no Pallas kernel: the JAX package leaves the resize to
XLA (``adamml_tpu/ops/augment.py::_one_sample``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import build

SOURCE = KERNEL = "crop_resize"

# launches of the CUDA kernel; a run sets it to 0 and reads it to show that
# its path went through the kernel
launch_counts = {KERNEL: 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (C, cons, rgbdiff) of the visual modalities, the kernel's three variants:
# rgb, flow, rgbdiff
VARIANTS = ((3, 1, False), (2, 5, False), (3, 5, True))

# a block's staged output rows stay within STAGE_BYTES, at most MAX_ROWS
# rows; each output of the block's sample's columns and rows takes one
# TAP_BYTES entry (csrc/crop_resize.cu's Tap) in shared memory beside them
STAGE_BYTES = 24 * 1024
MAX_ROWS = 16
TAP_BYTES = 32
MAX_SMEM_BYTES = 232448
# resample_weights zeroes an output whose weights sum to under this
TINY = 1000.0 * torch.finfo(torch.float32).eps


def plan(out_h: int, out_w: int, channels: int, itemsize: int) -> dict:
    """The launch's plan, which the C entry takes as it is: a block's
    output rows, the row tiles of a frame, the bytes of a block's staged
    rows (rounded up to 16) and its shared memory, for an output of
    ``out_h`` x ``out_w`` pixels of ``channels`` (cons * C) values of
    ``itemsize`` bytes."""
    row_bytes = out_w * channels * itemsize
    rows = max(1, min(MAX_ROWS, out_h, STAGE_BYTES // row_bytes))
    stage = -(-rows * row_bytes // 16) * 16
    return {"rows": rows, "tiles": -(-out_h // rows), "stage": stage,
            "smem": stage + (out_w + rows) * TAP_BYTES}


def axis_taps(in_size: int, out_size: int, origin: torch.Tensor,
              extent: torch.Tensor) -> dict:
    """The kernel's taps along one axis for crops starting at ``origin`` and
    ``extent`` pixels long ((N,) float32), in float32 with the kernel's
    operations in its order. Each output o samples the canvas at
    sample_f = (o + 0.5) * inv - (-origin * scale) * inv - 0.5, with
    scale = out / extent and inv = 1 / scale (each a number over a tensor,
    which PyTorch computes as the tensor's reciprocal times the number),
    through a triangle of half width ks = max(inv, 1). Per (sample,
    output):

    first, last     the candidates: floor(sample_f - ks) - 1 and
                    ceil(sample_f + ks) + 1, clipped to the canvas
    weights         max(1 - |sample_f - i| / ks, 0) over the candidates, 0
                    elsewhere ((N, out, in))
    total           their sum, added in canvas order
    lo, count       the band of nonzero weights: its first index and length;
                    count 0 where sample_f lies outside [-0.5, in - 0.5] or
                    the total is not above TINY (the output is then 0)
    """
    origin = origin.float()
    extent = extent.float()
    scale = out_size / extent
    inv = 1.0 / scale
    ks = torch.clamp(inv, min=1.0)
    shift = (-origin * scale) * inv
    pos = torch.arange(out_size, dtype=torch.float32, device=origin.device)
    sf = (pos[None, :] + 0.5) * inv[:, None] - shift[:, None] - 0.5
    ksb = ks[:, None].expand_as(sf)
    inside = (sf >= -0.5) & (sf <= in_size - 0.5)
    first = torch.clamp(torch.floor(sf - ksb) - 1.0, min=0.0)
    last = torch.clamp(torch.ceil(sf + ksb) + 1.0, max=float(in_size - 1))
    idx = torch.arange(in_size, dtype=torch.float32, device=origin.device)
    w = torch.clamp(1.0 - (sf[..., None] - idx).abs() / ksb[..., None],
                    min=0.0)
    cand = (idx >= first[..., None]) & (idx <= last[..., None])
    w = torch.where(cand & inside[..., None], w, torch.zeros_like(w))
    total = torch.zeros_like(sf)
    for i in range(in_size):  # the kernel's order
        total = total + w[..., i]
    nz = w > 0
    lo = torch.where(nz.any(-1), nz.float().argmax(-1),
                     torch.zeros_like(sf, dtype=torch.long))
    hi = in_size - 1 - nz.flip(-1).float().argmax(-1)
    valid = inside & (total > TINY)
    count = torch.where(valid, hi - lo + 1, torch.zeros_like(lo))
    return {"first": first.long(), "last": last.long(), "weights": w,
            "total": total,
            "lo": torch.where(valid, lo, torch.zeros_like(lo)),
            "count": count}


def band_weights(in_size: int, out_size: int, origin: torch.Tensor,
                 extent: torch.Tensor) -> torch.Tensor:
    """(N, out, in) float32: each output's band of ``axis_taps`` divided by
    its total, zeros elsewhere: the weights the kernel applies."""
    t = axis_taps(in_size, out_size, origin, extent)
    idx = torch.arange(in_size, device=t["lo"].device)
    band = ((idx >= t["lo"][..., None])
            & (idx < (t["lo"] + t["count"])[..., None]))
    total = torch.where(t["count"] > 0, t["total"],
                        torch.ones_like(t["total"]))
    return torch.where(band, t["weights"] / total[..., None],
                       torch.zeros_like(t["weights"]))


def work(frames_shape: Sequence[int], crop_xywh: torch.Tensor,
         out_size: int, cons: int, rgbdiff: bool, itemsize: int) -> int:
    """The least bytes a launch moves: for each sample, the canvas bytes
    under its taps' support (the rows and columns any output's band
    touches, in every canvas frame) read once, and the output written
    once."""
    _, t_in, h, w, c = frames_shape
    crop = crop_xywh.detach().float().cpu()
    n = crop.shape[0]

    def span(t):
        used = t["count"] > 0
        lo = torch.where(used, t["lo"], torch.full_like(t["lo"], 1 << 30))
        hi = torch.where(used, t["lo"] + t["count"] - 1,
                         torch.full_like(t["lo"], -1))
        return torch.clamp(hi.amax(1) - lo.amin(1) + 1, min=0)

    rows = span(axis_taps(h, out_size, crop[:, 1], crop[:, 3]))
    cols = span(axis_taps(w, out_size, crop[:, 0], crop[:, 2]))
    read = int((rows * cols).sum()) * t_in * c
    t_out = t_in // (cons + 1 if rgbdiff else cons)
    written = n * t_out * out_size * out_size * cons * c * itemsize
    return read + written


def _load():
    lib = build.load_library(SOURCE)
    if lib.crop_resize_error_string.restype is ctypes.c_char_p:
        return lib
    vp, i = ctypes.c_void_p, ctypes.c_int
    fp = ctypes.POINTER(ctypes.c_float)
    lib.crop_resize.argtypes = [vp] * 4 + [i] * 16 + [fp, fp, vp]
    lib.crop_resize.restype = i
    lib.crop_resize_error_string.argtypes = [i]
    lib.crop_resize_error_string.restype = ctypes.c_char_p
    return lib


def crop_resize(frames: torch.Tensor, crop_xywh: torch.Tensor,
                flip: torch.Tensor, *, out_size: int,
                mean: Optional[Sequence[float]],
                std: Optional[Sequence[float]], flow: bool = False,
                rgbdiff: bool = False, cons: int = 1, ncrops: int = 1,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One launch of the kernel (module docstring): ``frames`` uint8 on a
    card, ``crop_xywh`` (N, 4) float32 and ``flip`` (N,) bool beside it,
    N = Nc * ncrops, all contiguous; mean and std C floats each, or both
    None to skip the normalisation."""
    if frames.dtype != torch.uint8 or frames.dim() != 5:
        raise ValueError(f"frames must be (N, T, H, W, C) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    nc, t_in, h, w, c = frames.shape
    n = nc * ncrops
    if crop_xywh.dtype != torch.float32 or tuple(crop_xywh.shape) != (n, 4):
        raise ValueError(f"crop_xywh must be ({n}, 4) float32, got "
                         f"{tuple(crop_xywh.shape)} {crop_xywh.dtype}")
    if flip.dtype != torch.bool or tuple(flip.shape) != (n,):
        raise ValueError(f"flip must be ({n},) bool, got "
                         f"{tuple(flip.shape)} {flip.dtype}")
    if (c, cons, bool(rgbdiff)) not in VARIANTS or ncrops < 1:
        raise ValueError(f"(C, cons, rgbdiff) must be one of {VARIANTS} "
                         f"(rgb, flow, rgbdiff) and ncrops at least 1; got "
                         f"({c}, {cons}, {bool(rgbdiff)}), ncrops={ncrops}")
    per_out = cons + 1 if rgbdiff else cons
    if t_in % per_out or t_in == 0:
        raise ValueError(f"{t_in} canvas frames do not split into groups "
                         f"of {per_out}")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype must be one of {list(_DTYPE_CODE)}, "
                         f"got {out_dtype}")
    if (mean is None) != (std is None) or (
            mean is not None and not len(mean) == len(std) == c):
        raise ValueError(f"mean and std must both be None or {c} floats")
    for name, t in (("frames", frames), ("crop_xywh", crop_xywh),
                    ("flip", flip)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if not t.is_cuda or t.device != frames.device:
            raise ValueError(f"the kernel takes every operand on one card "
                             f"(the CPU takes augment.plain_crop_resize); "
                             f"{name} is on {t.device}, frames on "
                             f"{frames.device}")
    out = torch.empty((n, t_in // per_out, out_size, out_size, cons * c),
                      dtype=out_dtype, device=frames.device)
    pl = plan(out_size, out_size, cons * c, out.element_size())
    if pl["smem"] > MAX_SMEM_BYTES:
        raise ValueError(f"an output row of {out_size} x {cons * c} values "
                         f"needs {pl['smem']} bytes of shared memory")
    norm = (None, None) if mean is None else (
        (ctypes.c_float * c)(*mean), (ctypes.c_float * c)(*std))
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        lib = _load()
        err = lib.crop_resize(
            frames.data_ptr(), crop_xywh.data_ptr(), flip.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[out_dtype], c, cons, int(rgbdiff),
            int(flow), nc, ncrops, t_in, h, w, out_size, out_size,
            pl["rows"], pl["tiles"], pl["stage"], pl["smem"], *norm, stream)
    if err != 0:
        msg = lib.crop_resize_error_string(err).decode()
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} "
                           f"({msg})")
    launch_counts[KERNEL] += 1
    return out
