"""Fused 3x3 depthwise convolution (+ per-channel affine + optional ReLU6)
as a hand-written CUDA kernel (``csrc/depthwise.cu``).

    out = [relu6]( conv3x3_depthwise_SAME(x, w, stride) * scale + bias )

x: (B, H, W, C) bf16 or float32, channels last; w: (3, 3, C) per-channel
taps; scale, bias: (C,), each optional (None: the identity). Padding is
XLA's "SAME": at stride 2 on an even size it is (0, 1), not the symmetric
(1, 1) of a plain ``nn.Conv`` (``same_pads``). The nine shifted products are
summed in float32 in row-major tap order (dy, dx), then the affine, the clip
and one rounding to x's dtype.

Replaces the Pallas kernel ``_dw_kernel`` (``adamml_tpu/ops/pallas/
depthwise.py:78``, launched by ``_pallas_dw``). Bound by device memory on
the card: each input byte is read once and each output byte written once,
against 18 float32 operations per output element. A block stages its
tile's input window in shared memory once; ``tile_plan`` picks the tile per
layer shape and ``tile_windows`` spells out what each tile reads and writes
(the CPU tests check both).

One call puts one kernel on the device: the kernel reads the taps in their
own dtype (bf16 or float32) through their strides, so the permuted view the
model passes is not copied; the identity affine is a null pointer, not a
tensor of ones and zeros; the stride-1 input gradient reads the taps flipped
instead of a flipped copy, and without ReLU6 or an affine it takes the
cotangent as it comes (the JAX VJP's float32 round trip of a bf16 cotangent
is the identity).

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
import dataclasses
import functools
from typing import Callable, Iterator, Optional, Tuple

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

# the card's limits the tiling respects (H100 SXM): shared memory a block
# can use, and SMs; a block's staged window stays within SMEM_TARGET
MAX_SMEM_BYTES = 232448
NUM_SMS = 132
SMEM_TARGET = 48 * 1024
# threads a block, as the kernel's launch bounds
MAX_THREADS = 512


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


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The kernel's geometry for one layer: tiles of ``th`` output rows x
    ``tw`` output columns x ``cb`` channels of one image, ``vec`` channels
    a thread (a block has one thread per output column and channel group
    of a tile)."""
    b: int
    h: int
    w: int
    c: int
    stride: int
    itemsize: int
    th: int
    tw: int
    cb: int
    vec: int

    @property
    def oh(self) -> int:
        return same_pads(self.h, self.stride)[0]

    @property
    def ow(self) -> int:
        return same_pads(self.w, self.stride)[0]

    @property
    def pad_t(self) -> int:
        return same_pads(self.h, self.stride)[1]

    @property
    def pad_l(self) -> int:
        return same_pads(self.w, self.stride)[1]

    @property
    def threads(self) -> int:
        return self.tw * (self.cb // self.vec)

    @property
    def grid(self) -> Tuple[int, int, int]:
        """The tiles as (spatial tiles of an image, channel slices,
        images): the kernel's grid, one block a tile."""
        return (-(-self.oh // self.th) * -(-self.ow // self.tw),
                self.c // self.cb, self.b)

    @property
    def tiles(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def smem_bytes(self) -> int:
        """A full tile's staged input window (rounded up to 16 bytes) and
        11 float32 rows of CB (the taps and the affine). The C entry
        computes the same number."""
        rows_in = (self.th - 1) * self.stride + 3
        cols_in = (self.tw - 1) * self.stride + 3
        tile = rows_in * cols_in * self.cb * self.itemsize
        return -(-tile // 16) * 16 + 11 * self.cb * 4


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


# tile_plan's targets (from a sweep of plans at the flagship layers on the
# H100): rows a tile by stride, columns a tile at most, threads a block
TH_MAX = {1: 16, 2: 8}
TW_MAX = 16
THREADS_TARGET = 128
MIN_THREADS = 64
MIN_TILES = 4 * NUM_SMS


@functools.lru_cache(maxsize=None)
def tile_plan(b: int, h: int, w: int, c: int, stride: int,
              itemsize: int) -> TilePlan:
    """The tile the kernel takes for x (b, h, w, c) at ``stride``, with
    ``itemsize``-byte elements.

    A thread takes 4 channels (1 when C % 4 != 0): at 8, its 72 taps in
    registers held it to two blocks an SM and it lost at most layers. At
    stride 1 a tile takes the whole image's rows when the output has at
    most 20, else 16; at stride 2, 8 rows when the output has 40 or more,
    else 4. The output row splits into near-equal pieces of at most TW_MAX
    columns. A block takes about THREADS_TARGET threads of channel groups,
    with a pixel's slice a multiple of 32 bytes (a DRAM sector), else of 16
    (the 16-byte copies) where C allows; fewer while the window exceeds
    SMEM_TARGET, and fewer (down to MIN_THREADS threads) while the layer
    makes fewer than MIN_TILES tiles: the small late layers get their tiles
    from channel slices."""
    oh = same_pads(h, stride)[0]
    ow = same_pads(w, stride)[0]
    vec = 4 if c % 4 == 0 else 1
    groups = c // vec
    if stride == 1:
        th = oh if oh <= 20 else TH_MAX[1]
    else:
        th = min(oh, TH_MAX[2] if oh >= 40 else 4)
    tw = -(-ow // -(-ow // TW_MAX))
    divs = [d for d in _divisors(groups) if tw * d <= MAX_THREADS]
    aligned = ([d for d in divs if d * vec * itemsize % 32 == 0]
               or [d for d in divs if d * vec * itemsize % 16 == 0] or divs)
    gb = min(aligned, key=lambda d: (abs(tw * d - THREADS_TARGET), -d))

    def plan(gb_):
        return TilePlan(b, h, w, c, stride, itemsize, th, tw, gb_ * vec, vec)

    while plan(gb).smem_bytes > SMEM_TARGET and gb > aligned[0]:
        gb = max(d for d in aligned if d < gb)
    while plan(gb).tiles < MIN_TILES:
        smaller = [d for d in aligned if d < gb and tw * d >= MIN_THREADS]
        if not smaller:
            break
        gb = smaller[-1]
    return plan(gb)


def tile_windows(p: TilePlan) -> Iterator[dict]:
    """Every tile's work in one image, as the kernel computes it: output
    rows [oy0, oy1), columns [ox0, ox1), channels [c0, c1), and the input
    window it stages, rows [iy0, iy1) and columns [ix0, ix1) (outside the
    image: zeros)."""
    s = p.stride
    for c0 in range(0, p.c, p.cb):
        for oy0 in range(0, p.oh, p.th):
            rows = min(p.th, p.oh - oy0)
            for ox0 in range(0, p.ow, p.tw):
                cols = min(p.tw, p.ow - ox0)
                iy0, ix0 = oy0 * s - p.pad_t, ox0 * s - p.pad_l
                yield dict(oy0=oy0, oy1=oy0 + rows, ox0=ox0, ox1=ox0 + cols,
                           c0=c0, c1=c0 + p.cb,
                           iy0=iy0, iy1=iy0 + (rows - 1) * s + 3,
                           ix0=ix0, ix1=ix0 + (cols - 1) * s + 3)


def reference_impl(x: torch.Tensor, w: torch.Tensor,
                   scale: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], stride: int,
                   relu6: bool) -> torch.Tensor:
    """Plain PyTorch version: zero-pad SAME, add the nine shifted products
    in float32 in row-major tap order (as ``_dw_kernel:92-100``), apply the
    affine (None: identity) and the optional ReLU6, cast once."""
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
    if scale is not None:
        acc = acc * scale.float()
    if bias is not None:
        acc = acc + bias.float()
    if relu6:
        acc = torch.clamp(acc, 0.0, 6.0)
    return acc.to(x.dtype)


def check_args(x: torch.Tensor, w: torch.Tensor,
               scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               stride: int) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, wd, c = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be one of {list(_DTYPE_CODE)}, got "
                         f"{x.dtype}")
    if tuple(w.shape) != (3, 3, c) or w.dtype not in _DTYPE_CODE:
        raise ValueError(f"w must be (3, 3, {c}) in one of "
                         f"{list(_DTYPE_CODE)}, got {tuple(w.shape)} "
                         f"{w.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (c,)
                              or not t.is_floating_point()):
            raise ValueError(f"{name} must be floating ({c},), got "
                             f"{tuple(t.shape)} {t.dtype}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if b * h * wd * c == 0:
        raise ValueError(f"empty input: x {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (B, H, W, C)")
    if b > 65535 or h * wd * c >= 2 ** 31:
        raise ValueError(f"too large for one launch: {tuple(x.shape)}")


def _load():
    """The library of ``csrc/depthwise.cu`` with its C signatures
    declared."""
    lib = build.load_library(KERNEL)
    if lib.dw3x3_error_string.restype is ctypes.c_char_p:
        return lib
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dw3x3_fwd.argtypes = ([vp] * 5 + [i] * 13 + [ll] * 3 + [i] * 5
                              + [vp])
    lib.dw3x3_fwd.restype = i
    lib.dw3x3_error_string.argtypes = [i]
    lib.dw3x3_error_string.restype = ctypes.c_char_p
    return lib


def bind(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
         bias: Optional[torch.Tensor], stride: int, relu6: bool,
         flip: bool = False) -> Tuple[Callable[[], None], torch.Tensor]:
    """Check the operands, allocate the output and bind one launch's
    arguments: returns (launch, out), where ``launch()`` enqueues the kernel
    on the current stream (writing ``out``) and raises if the launch fails.
    It counts nothing: ``_launch`` counts the launches of a path, and a
    measurement can time ``launch`` alone."""
    if any(t is not None and t.device != x.device for t in (w, scale, bias)):
        raise ValueError("all operands must be on one CUDA device")
    check_args(x, w, scale, bias, stride)
    lib = _load()
    b, h, wd, c = x.shape
    p = tile_plan(b, h, wd, c, stride, x.element_size())
    # scale and bias are a few floats; the model gives neither
    s32 = None if scale is None else scale.float().contiguous()
    b32 = None if bias is None else bias.float().contiguous()
    out = torch.empty((b, p.oh, p.ow, c), dtype=x.dtype, device=x.device)
    async16 = int(x.data_ptr() % 16 == 0 and c * x.element_size() % 16 == 0
                  and p.cb * x.element_size() % 16 == 0)
    sdy, sdx, sc = w.stride()
    args = (x.data_ptr(), w.data_ptr(),
            None if s32 is None else s32.data_ptr(),
            None if b32 is None else b32.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], b, h, wd, c, p.oh,
            p.ow, stride, p.pad_t, p.pad_l, int(relu6), int(flip), sdy, sdx,
            sc, p.th, p.tw, p.cb, p.vec, async16)
    device = x.device

    def launch() -> None:
        # the operands stay referenced by this closure while it lives
        _ = (x, w, s32, b32)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.dw3x3_fwd(*args, stream)
        if err != 0:
            msg = lib.dw3x3_error_string(err).decode()
            raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} "
                               f"({msg}) for x {tuple(x.shape)} at stride "
                               f"{stride}, plan {p}")

    return launch, out


def _launch(x, w, scale, bias, stride: int, relu6: bool,
            key: str = KERNEL, flip: bool = False) -> torch.Tensor:
    launch, out = bind(x, w, scale, bias, stride, relu6, flip)
    launch()
    launch_counts[key] += 1
    return out


def _dw(x, w, scale, bias, stride: int, relu6: bool, key: str = KERNEL,
        flip: bool = False) -> torch.Tensor:
    """The kernel for a CUDA tensor, counted under ``key``; the plain
    version for a CPU one. ``flip`` reads the taps as w[2-dy, 2-dx]."""
    if x.is_cuda:
        return _launch(x, w, scale, bias, stride, relu6, key, flip)
    if x.device.type == "cpu":
        return reference_impl(x, w.flip(0, 1) if flip else w, scale, bias,
                              stride, relu6)
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
    def forward(ctx, x, w, scale, bias, stride, relu6):
        out = _dw(x, w, scale, bias, stride, relu6)
        ctx.stride, ctx.relu6 = stride, relu6
        ctx.has_affine = scale is not None or bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(x, w, scale, out if relu6 else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, scale, out = ctx.saved_tensors
        stride, c = ctx.stride, x.shape[-1]
        need_x, need_w, need_s, need_b = ctx.needs_input_grad[:4]
        dx = dw = dscale = dbias = None
        if ctx.relu6 or ctx.has_affine:
            g = g.float()
            if ctx.relu6:  # d relu6: pass-through on (0, 6) of the rounded out
                outf = out.float()
                g = g * ((outf > 0.0) & (outf < 6.0)).float()
            if need_s:
                conv = _conv_only(x.float(), w.float(), stride)
                dscale = (g * conv).sum(dim=(0, 1, 2)).to(scale.dtype)
            if need_b:
                dbias = g.sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
            gc = g if scale is None else g * scale.float()
        else:
            # in x's dtype: JAX's float32 round trip of it is the identity
            gc = g
        if need_x:
            if stride == 1:
                # the adjoint of a stride-1 SAME 3x3 conv is the same conv
                # with flipped taps: the kernel again
                dx = _dw(gc.to(x.dtype).contiguous(), w, None, None, 1,
                         False, KERNEL_DX, True)
            else:
                xp = _padded(x.float(), stride)
                dxp = torch.nn.grad.conv2d_input(
                    xp.shape, w.float().permute(2, 0, 1)[:, None],
                    _nchw(gc.float()), stride=stride, groups=c)
                _, ph_lo, _ = same_pads(x.shape[1], stride)
                _, pw_lo, _ = same_pads(x.shape[2], stride)
                dx = dxp[:, :, ph_lo:ph_lo + x.shape[1],
                         pw_lo:pw_lo + x.shape[2]].permute(0, 2, 3, 1)
                dx = dx.to(x.dtype)
        if need_w:
            dwt = torch.nn.grad.conv2d_weight(
                _padded(x.float(), stride), (c, 1, 3, 3), _nchw(gc.float()),
                stride=stride, groups=c)
            dw = dwt[:, 0].permute(1, 2, 0).to(w.dtype)
        return dx, dw, dscale, dbias, None, None


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                      scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      relu6: bool = False) -> torch.Tensor:
    """Fused depthwise 3x3 conv + per-channel affine + optional ReLU6, with
    its gradient to all four operands.

    x: (B, H, W, C); w: (3, 3, C) per-channel taps, bf16 or float32, any
    strides; scale/bias: (C,) (the folded BN affine; identity when None).
    Returns (B, OH, OW, C) in x.dtype. CUDA tensors run the kernel (one
    launch); CPU tensors the plain version."""
    return _DepthwiseFn.apply(x, w, scale, bias, stride, relu6)
