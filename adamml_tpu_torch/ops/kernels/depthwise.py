"""Fused 3x3 depthwise convolution (+ per-channel affine + optional ReLU6)
as a hand-written CUDA kernel (``csrc/depthwise.cu``).

    out = [relu6]( conv3x3_depthwise_SAME(x, w, stride) * scale + bias )

x: (B, H, W, C) bf16 or float32, channels last; w: (3, 3, C) per-channel
taps; scale, bias: (C,). Padding is XLA's "SAME": at stride 2 on an even
size it is (0, 1), not the symmetric (1, 1) of a plain ``nn.Conv``
(``same_pads``). The nine shifted products are summed in float32 in
row-major tap order (dy, dx), then the affine, the clip and one rounding to
x's dtype.

Replaces the Pallas kernel ``_dw_kernel`` (``adamml_tpu/ops/pallas/
depthwise.py:78``, launched by ``_pallas_dw``). Bound by device memory on
the card: each input byte is read once and each output byte written once,
against 18 float32 operations per output element.

``depthwise_conv3x3`` is a ``torch.autograd.Function`` mirroring the JAX
custom VJP (``_dw_fused``/``_dw_fwd``/``_dw_bwd``): the ReLU6 mask comes
from the rounded output; the affine's gradients only when an affine was
given; the stride-1 input gradient is the same kernel on the cotangent with
spatially flipped taps; the stride-2 input gradient and the filter gradient
are float32 library convolutions, as XLA computes them outside any Pallas
kernel. A CPU tensor takes ``reference_impl``; a CUDA tensor launches the
kernel or the call raises. There is no shape gate.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

KERNEL = "depthwise"
KERNEL_DX = "depthwise_dx"

# launches of the CUDA kernel, as the forward and as the stride-1 input
# gradient; a run sets them to 0 and reads them to show that its path went
# through the kernel
launch_counts = {KERNEL: 0, KERNEL_DX: 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def same_pads(size: int, stride: int, k: int = 3) -> Tuple[int, int, int]:
    """(out, lo, hi) of XLA's "SAME" padding (``_same_pads``,
    depthwise.py:107-113): total = max(0, (out-1)*stride + k - size),
    lo = total // 2, so stride 2 on an even size pads (0, 1). ``hi`` also
    covers the last tap at full stride, as ``_pallas_dw:121-124`` pads it;
    for k = 3 at stride 1 or 2 that is the same number."""
    out = (size + stride - 1) // stride
    total = max(0, (out - 1) * stride + k - size)
    lo = total // 2
    hi = max(total - lo, (out - 1) * stride + k - size - lo)
    return out, lo, hi


def reference_impl(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, stride: int,
                   relu6: bool) -> torch.Tensor:
    """Plain PyTorch version: zero-pad SAME, add the nine shifted products
    in float32 in row-major tap order (as ``_dw_kernel:92-100``), apply the
    affine and the optional ReLU6, cast once."""
    b, h, wd, c = x.shape
    oh, ph_lo, ph_hi = same_pads(h, stride)
    ow, pw_lo, pw_hi = same_pads(wd, stride)
    xp = F.pad(x.float(), (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    taps = w.float()
    acc = torch.zeros((b, oh, ow, c), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            win = xp[:, dy:dy + stride * (oh - 1) + 1:stride,
                     dx:dx + stride * (ow - 1) + 1:stride]
            acc = acc + win * taps[dy, dx]
    acc = acc * scale.float() + bias.float()
    if relu6:
        acc = torch.clamp(acc, 0.0, 6.0)
    return acc.to(x.dtype)


def check_args(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, stride: int) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, wd, c = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be one of {list(_DTYPE_CODE)}, got "
                         f"{x.dtype}")
    if tuple(w.shape) != (3, 3, c) or not w.is_floating_point():
        raise ValueError(f"w must be floating (3, 3, {c}), got "
                         f"{tuple(w.shape)} {w.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (c,) or not t.is_floating_point():
            raise ValueError(f"{name} must be floating ({c},), got "
                             f"{tuple(t.shape)} {t.dtype}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if b * h * wd * c == 0:
        raise ValueError(f"empty input: x {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (B, H, W, C)")
    if b * h * wd * c >= 2 ** 31 * 256:
        raise ValueError(f"too many threads for one launch: {tuple(x.shape)}")


def _load():
    """The library of ``csrc/depthwise.cu`` with its C signatures
    declared."""
    lib = build.load_library(KERNEL)
    if lib.dw3x3_error_string.restype is ctypes.c_char_p:
        return lib
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dw3x3_fwd.argtypes = [vp] * 5 + [i] * 12 + [vp]
    lib.dw3x3_fwd.restype = i
    lib.dw3x3_error_string.argtypes = [i]
    lib.dw3x3_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, w, scale, bias, stride: int, relu6: bool,
            key: str = KERNEL) -> torch.Tensor:
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("all operands must be on one CUDA device")
    check_args(x, w, scale, bias, stride)
    lib = _load()
    b, h, wd, c = x.shape
    oh, ph_lo, _ = same_pads(h, stride)
    ow, pw_lo, _ = same_pads(wd, stride)
    # the kernel reads float32 taps, scale and bias (the Pallas kernel casts
    # each to float32 before use); tiny (9C + 2C) copies
    taps = w.float().contiguous()
    s32, b32 = scale.float().contiguous(), bias.float().contiguous()
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    vec = int(c % 8 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (x, taps, s32, b32)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dw3x3_fwd(
            x.data_ptr(), taps.data_ptr(), s32.data_ptr(), b32.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[x.dtype], b, h, wd, c, oh, ow,
            stride, ph_lo, pw_lo, int(relu6), vec, stream)
    if err != 0:
        msg = lib.dw3x3_error_string(err).decode()
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} ({msg})")
    launch_counts[key] += 1
    return out


def _dw(x, w, scale, bias, stride: int, relu6: bool,
        key: str = KERNEL) -> torch.Tensor:
    """The kernel for a CUDA tensor, counted under ``key``; the plain
    version for a CPU one."""
    if x.is_cuda:
        return _launch(x, w, scale, bias, stride, relu6, key)
    if x.device.type == "cpu":
        return reference_impl(x, w, scale, bias, stride, relu6)
    raise ValueError(f"unsupported device {x.device}")


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _padded(x32: torch.Tensor, stride: int) -> torch.Tensor:
    """x (B, H, W, C) float32 zero-padded SAME, as an NCHW view."""
    _, ph_lo, ph_hi = same_pads(x32.shape[1], stride)
    _, pw_lo, pw_hi = same_pads(x32.shape[2], stride)
    return _nchw(F.pad(x32, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi)))


def _conv_only(x32: torch.Tensor, w32: torch.Tensor,
               stride: int) -> torch.Tensor:
    """The float32 SAME depthwise convolution alone, (B, OH, OW, C)."""
    c = x32.shape[-1]
    out = F.conv2d(_padded(x32, stride), w32.permute(2, 0, 1)[:, None],
                   stride=stride, groups=c)
    return out.permute(0, 2, 3, 1)


class _DepthwiseFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, bias, stride, relu6, has_affine):
        out = _dw(x, w, scale, bias, stride, relu6)
        ctx.stride, ctx.relu6, ctx.has_affine = stride, relu6, has_affine
        ctx.bias_dtype = bias.dtype
        ctx.save_for_backward(x, w, scale, out if relu6 else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, scale, out = ctx.saved_tensors
        stride, c = ctx.stride, x.shape[-1]
        need_x, need_w, need_s, need_b = ctx.needs_input_grad[:4]
        g = g.float()
        if ctx.relu6:  # d relu6: pass-through on (0, 6) of the rounded out
            outf = out.float()
            g = g * ((outf > 0.0) & (outf < 6.0)).float()
        dx = dw = dscale = dbias = None
        if ctx.has_affine:
            if need_s:
                conv = _conv_only(x.float(), w.float(), stride)
                dscale = (g * conv).sum(dim=(0, 1, 2)).to(scale.dtype)
            if need_b:
                dbias = g.sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
            gc = g * scale.float()
        else:
            gc = g
        if need_x:
            if stride == 1:
                # the adjoint of a stride-1 SAME 3x3 conv is the same conv
                # with flipped taps: the kernel again
                ones = torch.ones(c, dtype=torch.float32, device=x.device)
                dx = _dw(gc.to(x.dtype).contiguous(), w.flip(0, 1), ones,
                         torch.zeros_like(ones), 1, False, KERNEL_DX)
            else:
                xp = _padded(x.float(), stride)
                dxp = torch.nn.grad.conv2d_input(
                    xp.shape, w.float().permute(2, 0, 1)[:, None],
                    _nchw(gc), stride=stride, groups=c)
                _, ph_lo, _ = same_pads(x.shape[1], stride)
                _, pw_lo, _ = same_pads(x.shape[2], stride)
                dx = dxp[:, :, ph_lo:ph_lo + x.shape[1],
                         pw_lo:pw_lo + x.shape[2]].permute(0, 2, 3, 1)
                dx = dx.to(x.dtype)
        if need_w:
            dwt = torch.nn.grad.conv2d_weight(
                _padded(x.float(), stride), (c, 1, 3, 3), _nchw(gc),
                stride=stride, groups=c)
            dw = dwt[:, 0].permute(1, 2, 0).to(w.dtype)
        return dx, dw, dscale, dbias, None, None, None


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                      scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      relu6: bool = False) -> torch.Tensor:
    """Fused depthwise 3x3 conv + per-channel affine + optional ReLU6, with
    its gradient to all four operands.

    x: (B, H, W, C); w: (3, 3, C) per-channel taps; scale/bias: (C,) (the
    folded BN affine; identity when None). Returns (B, OH, OW, C) in
    x.dtype. CUDA tensors run the kernel; CPU tensors the plain version."""
    c = x.shape[-1]
    has_affine = scale is not None or bias is not None
    if scale is None:
        scale = torch.ones(c, dtype=torch.float32, device=x.device)
    if bias is None:
        bias = torch.zeros(c, dtype=torch.float32, device=x.device)
    return _DepthwiseFn.apply(x, w, scale, bias, stride, relu6, has_affine)
