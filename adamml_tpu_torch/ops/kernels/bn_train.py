"""Train-mode grouped batch norm as hand-written CUDA kernels
(``csrc/bn_train.cu``): one autograd function whose forward is a stats
pass, a small finalize and an apply pass over x, and whose backward is one
reduction pass over (dy, x), a small finalize and one dx pass.

x is (n, ..., C) with its rows (clips, segments, frames)-ordered: viewed as
(R replica groups, clips per group, S segments, si frames, P pixels, C),
group g = rep * S + s takes its moments over (clips, frames, pixels), in
float32 (``models/norm.py``):

    mean, meansq = E[x], E[x^2]                               (G, C)
    var = meansq - mean^2;  a = w * rsqrt(var + eps);  b = bias - mean * a
    y = x * a[g] + b[g]     (float32, one rounding to x's dtype)

and the running statistics fold replica 0's S moment sets in segment order,
the variance unbiased by count / (count - 1): ra <- m^S ra + sum_i (1 - m)
m^(S-1-i) moment_i. The backward is the autograd of these formulas written
out: per group da = sum(dy * x), db = sum(dy); then dweight, dbias and the
per-group coefficients of dx = dy * a + dmean / N + x * 2 dmeansq / N.
With ``return_affine`` the forward returns (a, b) (R, S, C) and does not
apply them (the epilogue kernel does, ``tpool_fused.py``); its backward
then takes (da, db) from the caller and writes no dy * a term.
``reduce_moments`` (sync-BN) is called on the stacked (mean, meansq)
(2, G, C) between the forward's two finalize halves, and on the moments'
gradients before the dx pass.

Saved for the backward: x in its own dtype and the (2, G, C) float32
moments; no float32 copy of an activation.

A CPU tensor takes the plain PyTorch version of each kernel (``plain_*``,
in x's precision for float64 and float32 otherwise); a CUDA tensor launches
the kernels or the call raises. The kernels replace no Pallas kernel: the
JAX package leaves train-mode BN to XLA. ``plan`` is the four passes'
launch plan, made here so that the CPU tests can check it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from . import build

SOURCE = "bn_train"
KERNELS = ("bn_stats", "bn_finalize", "bn_apply", "bn_grad_sums",
           "bn_grad_finalize", "bn_dx")

# launches of the CUDA kernels, by kernel; a run sets them to 0 and reads
# them to show that its path went through the kernels
launch_counts = {k: 0 for k in KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# finalize modes (csrc/bn_train.cu): the slabs' sums to the moments, the
# moments to (a, b) and the running statistics, or both in one launch
MOMENTS, AFFINE = 1, 2

# the passes' block: at most 256 threads, as pixel lanes by channel groups
# of one 16-byte vector, at most 32 groups (a 512-byte line of bf16) a
# block; slabs of at least 8 pixels a lane; about 8 blocks an SM in all,
# two to four rounds of the 2 (dx in bf16, 118 registers) or 3 (the other
# passes, 66-76 registers) blocks an SM holds. 12 an SM, whole rounds of
# both, timed no faster on the card and made the finalize slower
THREADS = 256
MAX_CHANNEL_GROUPS = 32
LANE_PIXELS_MIN = 8
BLOCKS_PER_SM = 8
H100_SMS = 132


@dataclass(frozen=True)
class Geom:
    """x as (n rows, p pixels a row, c channels), its rows in r replica
    groups of s segments of si frames each (``models/norm.py``)."""

    n: int
    p: int
    c: int
    r: int = 1
    s: int = 1
    si: int = 1

    @property
    def g(self) -> int:
        """moment groups, R * S"""
        return self.r * self.s

    @property
    def count(self) -> int:
        """elements a group takes its moments over, a channel"""
        return self.n // self.g * self.p

    def grouped(self, t: torch.Tensor) -> torch.Tensor:
        """(n, ..., c) as (R, clips, S, si, P, C)."""
        return t.reshape(self.r, self.n // (self.g * self.si), self.s,
                         self.si, self.p, self.c)

    def per_group(self, t: torch.Tensor) -> torch.Tensor:
        """(G, C) as broadcastable against ``grouped``."""
        return t.reshape(self.r, 1, self.s, 1, 1, self.c)


_RED = (1, 3, 4)  # the grouped view's reduced axes


def geometry(shape, r: int = 1, s: int = 1, si: int = 1) -> Geom:
    n, c = shape[0], shape[-1]
    return Geom(n, math.prod(shape[1:-1]), c, r, s, si)


def vec_width(c: int, itemsize: int, aligned: bool = True) -> int:
    """Channels a thread loads at once: one 16-byte vector when C splits
    into them and every operand it loads or stores so (x, dy, the output)
    is 16-byte aligned, else 1."""
    v = 16 // itemsize
    return v if aligned and c % v == 0 else 1


@functools.lru_cache(maxsize=512)
def plan(geom: Geom, vec: int, sms: int = H100_SMS) -> dict:
    """The launch plan of the four passes over x (stats, apply, grad sums,
    dx) for ``geom`` at ``vec`` channels a thread, on a card of ``sms`` SMs.

    A block owns one (group, slab of the group's pixels, channel slice):
    ``tcg`` channel groups of ``vec`` channels by ``lanes`` pixel lanes.
    The slabs of a group are as many as give about BLOCKS_PER_SM blocks an
    SM in all, and no fewer than LANE_PIXELS_MIN pixels a lane; so the
    partials (G, K, 2, C) stay a few percent of x's bytes. The plan, and
    with it the order of every sum, depends on the shape alone."""
    groups = -(-geom.c // vec)
    ns = -(-groups // MAX_CHANNEL_GROUPS)
    tcg = -(-groups // ns)
    lanes = max(1, THREADS // tcg)
    q = geom.count
    by_blocks = -(-BLOCKS_PER_SM * sms // (geom.g * ns))
    by_pixels = q // (lanes * LANE_PIXELS_MIN)
    k = max(1, min(by_blocks, by_pixels))
    slab = -(-q // k)
    k = -(-q // slab)
    return {"vec": vec, "tcg": tcg, "lanes": lanes, "ns": ns, "k": k,
            "slab": slab, "threads": tcg * lanes,
            "blocks": geom.g * k * ns,
            "partials_bytes": geom.g * k * 2 * geom.c * 4}


# -- plain versions (CPU) -----------------------------------------------------


def _acc(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def plain_stats(x: torch.Tensor, geom: Geom) -> torch.Tensor:
    """(G, 1, 2, C) sums of x and x * x over each group."""
    xf = geom.grouped(x).to(_acc(x))
    sums = torch.stack([xf.sum(_RED), (xf * xf).sum(_RED)], dim=2)
    return sums.reshape(geom.g, 1, 2, geom.c)


def plain_finalize(sums: Optional[Tuple[torch.Tensor, torch.Tensor]],
                   mom: Optional[torch.Tensor], weight, bias, running,
                   geom: Geom, unbias: float, momentum: float, eps: float,
                   mode: int):
    """(mom (2, G, C), a (G, C), b (G, C)) from the slabs' sums (each
    (G, K, C)) or, without MOMENTS, from ``mom``; with AFFINE and
    ``running`` = (mean, var) buffers, folds replica 0's moments into
    them in place. a and b are None without AFFINE."""
    if mode & MOMENTS:
        mom = torch.stack([sums[0].sum(1), sums[1].sum(1)]) / geom.count
    if not mode & AFFINE:
        return mom, None, None
    mean, meansq = mom[0], mom[1]
    var = meansq - mean * mean
    a = weight * torch.rsqrt(var + eps)
    b = bias - mean * a
    if running is not None:
        s = geom.s
        w = (1.0 - momentum) * torch.pow(momentum, torch.arange(
            s - 1, -1, -1, dtype=mom.dtype, device=mom.device))
        with torch.no_grad():
            running[0].mul_(momentum ** s).add_(w @ mean[:s])
            running[1].mul_(momentum ** s).add_(w @ (var[:s] * unbias))
    return mom, a, b


def plain_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                geom: Geom) -> torch.Tensor:
    """x * a[g] + b[g] in a's precision, rounded once to x's dtype."""
    y = torch.addcmul(geom.per_group(b), geom.grouped(x), geom.per_group(a))
    return y.reshape(x.shape).to(x.dtype)


def plain_grad_sums(dy: torch.Tensor, x: torch.Tensor,
                    geom: Geom) -> torch.Tensor:
    """(G, 1, 2, C) sums of dy * x and dy over each group."""
    acc = _acc(x)
    d = geom.grouped(dy).to(acc)
    sums = torch.stack([(d * geom.grouped(x).to(acc)).sum(_RED),
                        d.sum(_RED)], dim=2)
    return sums.reshape(geom.g, 1, 2, geom.c)


def plain_grad_finalize(sums: Tuple[torch.Tensor, torch.Tensor],
                        mom: torch.Tensor, weight: torch.Tensor,
                        geom: Geom, eps: float):
    """(dweight, dbias, coef (3, G, C) = (a, dmean / N, 2 dmeansq / N))
    from the per-group (da, db), each (G, K, C) summed over K."""
    da, db = sums[0].sum(1), sums[1].sum(1)
    mean, meansq = mom[0], mom[1]
    var = meansq - mean * mean
    rstd = torch.rsqrt(var + eps)
    a = weight * rstd
    ga = da - db * mean
    dweight = (ga * rstd).sum(0)
    dbias = db.sum(0)
    gvar = ga * weight * -0.5 * rstd ** 3
    gmean = -db * a - 2 * mean * gvar
    coef = torch.stack([a, gmean / geom.count, 2 * (gvar / geom.count)])
    return dweight, dbias, coef


def plain_dx(dy: Optional[torch.Tensor], x: torch.Tensor, coef: torch.Tensor,
             geom: Geom) -> torch.Tensor:
    """dy * a + dmean / N + x * (2 dmeansq / N) in coef's precision, one
    rounding to x's dtype; no dy term when dy is None."""
    a, c0, c1 = (geom.per_group(t) for t in coef)
    out = torch.addcmul(c0, geom.grouped(x), c1)
    if dy is not None:
        out = torch.addcmul(out, geom.grouped(dy), a)
    return out.reshape(x.shape).to(x.dtype)


# -- the kernels --------------------------------------------------------------


class _Shape(ctypes.Structure):
    """csrc/bn_train.cu's Shape."""

    _fields_ = [(k, ctypes.c_int64) for k in (
        "n", "p", "c", "r", "s", "si", "vec", "tcg", "lanes", "ns", "k",
        "slab")]


def _load():
    lib = build.load_library(SOURCE)
    if lib.bn_train_error_string.restype is ctypes.c_char_p:
        return lib
    vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
    sp = ctypes.POINTER(_Shape)
    lib.bn_train_stats.argtypes = [vp, vp, i, sp, vp]
    lib.bn_train_apply.argtypes = [vp, vp, vp, vp, i, sp, vp]
    lib.bn_train_grad_sums.argtypes = [vp, vp, vp, i, sp, vp]
    lib.bn_train_dx.argtypes = [vp, vp, vp, vp, i, sp, vp]
    lib.bn_train_finalize.argtypes = ([vp, vp, ll, ll, ll] + [vp] * 7
                                      + [ll, ll, ll] + [f] * 6 + [i, vp])
    lib.bn_train_grad_finalize.argtypes = ([vp, vp, ll, ll, ll] + [vp] * 5
                                           + [ll, ll, f, f, vp])
    for fn in (lib.bn_train_stats, lib.bn_train_apply,
               lib.bn_train_grad_sums, lib.bn_train_dx,
               lib.bn_train_finalize, lib.bn_train_grad_finalize):
        fn.restype = i
    lib.bn_train_error_string.argtypes = [i]
    lib.bn_train_error_string.restype = ctypes.c_char_p
    return lib


def _run(kernel: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        msg = _load().bn_train_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
    launch_counts[kernel] += 1


_SMS = {}


def _sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _shape(x: torch.Tensor, geom: Geom,
           *others: Optional[torch.Tensor]) -> Tuple[_Shape, dict]:
    """The pass's shape and plan; ``others`` are the operands besides x
    that the pass reads or writes by x's vectors (dy, the output)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + others
                  if t is not None)
    pl = plan(geom, vec_width(geom.c, x.element_size(), aligned),
              _sms(x.device))
    return _Shape(geom.n, geom.p, geom.c, geom.r, geom.s, geom.si,
                  *(pl[k] for k in ("vec", "tcg", "lanes", "ns", "k",
                                    "slab"))), pl


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(x: torch.Tensor, geom: Geom, *others: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be one of {list(_DTYPE_CODE)}, got "
                         f"{x.dtype}")
    if x.numel() != geom.n * geom.p * geom.c or x.numel() == 0:
        raise ValueError(f"x {tuple(x.shape)} is not {geom}")
    if geom.n % (geom.g * geom.si):
        raise ValueError(f"rows n={geom.n} do not split into R={geom.r} x "
                         f"S={geom.s} x si={geom.si}")
    for t in (x,) + others:
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.device != x.device:
            raise ValueError("all operands must be on one CUDA device")


def _need_f32(numel: int, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.numel() != numel:
            raise ValueError(f"{name} must be float32 of {numel} elements, "
                             f"got {t.dtype} of {t.numel()}")


def slab_views(part: torch.Tensor):
    """(G, K, 2, C) partials as two (G, K, C) views."""
    return part[:, :, 0], part[:, :, 1]


def stats(x: torch.Tensor, geom: Geom) -> torch.Tensor:
    """(G, K, 2, C) float32 partial sums of x and x * x (K slabs a group;
    1 on the CPU)."""
    if not x.is_cuda:
        return plain_stats(x, geom)
    _check(x, geom)
    sh, pl = _shape(x, geom)
    part = torch.empty((geom.g, pl["k"], 2, geom.c), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        _run("bn_stats", _load().bn_train_stats, x.data_ptr(),
             part.data_ptr(), _DTYPE_CODE[x.dtype], ctypes.byref(sh),
             _stream(x))
    return part


def grad_sums(dy: torch.Tensor, x: torch.Tensor, geom: Geom) -> torch.Tensor:
    """(G, K, 2, C) float32 partial sums of dy * x and dy."""
    if not x.is_cuda:
        return plain_grad_sums(dy, x, geom)
    _check(x, geom, dy)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"dy must be x's shape and dtype, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    sh, pl = _shape(x, geom, dy)
    part = torch.empty((geom.g, pl["k"], 2, geom.c), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        _run("bn_grad_sums", _load().bn_train_grad_sums, dy.data_ptr(),
             x.data_ptr(), part.data_ptr(), _DTYPE_CODE[x.dtype],
             ctypes.byref(sh), _stream(x))
    return part


def _gkc(t: torch.Tensor, geom: Geom) -> Tuple[torch.Tensor, int, int]:
    """t as (G, K, C) float32 with unit channel stride: (view, sg, sk)."""
    v = t.reshape(geom.g, -1, geom.c)
    if v.stride(2) != 1:
        v = v.contiguous()
    return v, v.stride(0), v.stride(1)


def finalize(sums, mom, weight, bias, running, geom: Geom, unbias: float,
             momentum: float, eps: float, mode: int):
    """``plain_finalize`` on the card: (mom, a, b), the running statistics
    (a (mean, var) pair, or None) folded in place."""
    dev = weight.device
    if not weight.is_cuda:
        return plain_finalize(sums, mom, weight, bias, running, geom, unbias,
                              momentum, eps, mode)
    gc, c = geom.g * geom.c, geom.c
    _need_f32(c, weight=weight, bias=bias)
    p0 = p1 = None
    sg = sk = k = 0
    if mode & MOMENTS:
        (p0, sg, sk), (p1, _, _) = _gkc(sums[0], geom), _gkc(sums[1], geom)
        k = p0.shape[1]
        mom = torch.empty((2, geom.g, geom.c), dtype=torch.float32,
                          device=dev)
    _need_f32(2 * gc, mom=mom)
    a = b = None
    rm = rv = None
    if mode & AFFINE:
        a = torch.empty((geom.g, c), dtype=torch.float32, device=dev)
        b = torch.empty_like(a)
        if running is not None:
            rm, rv = running
            _need_f32(c, running_mean=rm, running_var=rv)
    with torch.cuda.device(dev):
        _run("bn_finalize", _load().bn_train_finalize,
             p0.data_ptr() if p0 is not None else None,
             p1.data_ptr() if p1 is not None else None, sg, sk, k,
             mom.data_ptr(), weight.data_ptr(), bias.data_ptr(),
             a.data_ptr() if a is not None else None,
             b.data_ptr() if b is not None else None,
             rm.data_ptr() if rm is not None else None,
             rv.data_ptr() if rv is not None else None,
             c, geom.r, geom.s, float(geom.count), unbias, momentum ** geom.s,
             momentum, 1.0 - momentum, eps, mode, _stream(weight))
    return mom, a, b


def apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          geom: Geom) -> torch.Tensor:
    """y = x * a[g] + b[g], in x's dtype."""
    if not x.is_cuda:
        return plain_apply(x, a, b, geom)
    _check(x, geom, a, b)
    _need_f32(geom.g * geom.c, a=a, b=b)
    y = torch.empty_like(x)
    sh, _ = _shape(x, geom, y)
    with torch.cuda.device(x.device):
        _run("bn_apply", _load().bn_train_apply, x.data_ptr(), a.data_ptr(),
             b.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype],
             ctypes.byref(sh), _stream(x))
    return y


def grad_finalize(sums, mom: torch.Tensor, weight: torch.Tensor, geom: Geom,
                  eps: float):
    """``plain_grad_finalize`` on the card."""
    if not weight.is_cuda:
        return plain_grad_finalize(sums, mom, weight, geom, eps)
    dev, c = weight.device, geom.c
    _need_f32(c, weight=weight)
    _need_f32(2 * geom.g * c, mom=mom)
    (p0, sg, sk), (p1, sg1, sk1) = _gkc(sums[0], geom), _gkc(sums[1], geom)
    if (sg1, sk1) != (sg, sk):
        p0, p1 = p0.contiguous(), p1.contiguous()
        sg, sk = p0.stride(0), p0.stride(1)
    _need_f32(p0.numel(), da=p0, db=p1)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(weight)
    coef = torch.empty((3, geom.g, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run("bn_grad_finalize", _load().bn_train_grad_finalize,
             p0.data_ptr(), p1.data_ptr(), sg, sk, p0.shape[1],
             mom.data_ptr(), weight.data_ptr(), dweight.data_ptr(),
             dbias.data_ptr(), coef.data_ptr(), c, geom.g,
             float(geom.count), eps, _stream(weight))
    return dweight, dbias, coef


def dx(dy: Optional[torch.Tensor], x: torch.Tensor, coef: torch.Tensor,
       geom: Geom) -> torch.Tensor:
    """dy * a + dmean / N + x * 2 dmeansq / N in x's dtype (no dy term when
    dy is None)."""
    if not x.is_cuda:
        return plain_dx(dy, x, coef, geom)
    _check(x, geom, coef, *(() if dy is None else (dy,)))
    if dy is not None and (dy.dtype != x.dtype or dy.shape != x.shape):
        raise ValueError(f"dy must be x's shape and dtype, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    _need_f32(3 * geom.g * geom.c, coef=coef)
    out = torch.empty_like(x)
    sh, _ = _shape(x, geom, dy, out)
    with torch.cuda.device(x.device):
        _run("bn_dx", _load().bn_train_dx,
             dy.data_ptr() if dy is not None else None, x.data_ptr(),
             coef.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
             ctypes.byref(sh), _stream(x))
    return out


# -- the autograd function ----------------------------------------------------


class _GroupedBNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running, geom, unbias, momentum, eps,
                reduce_moments, return_affine):
        if x.is_cuda:
            x = x.contiguous()
        part = stats(x, geom)
        sums = slab_views(part)
        if reduce_moments is None:
            mom, a, b = finalize(sums, None, weight, bias, running, geom,
                                 unbias, momentum, eps, MOMENTS | AFFINE)
        else:
            mom, _, _ = finalize(sums, None, weight, bias, None, geom,
                                 unbias, momentum, eps, MOMENTS)
            mom = reduce_moments(mom)
            _, a, b = finalize(None, mom, weight, bias, running, geom,
                               unbias, momentum, eps, AFFINE)
        ctx.save_for_backward(x, weight, mom)
        ctx.geom, ctx.eps = geom, eps
        ctx.reduce_moments, ctx.return_affine = reduce_moments, return_affine
        if return_affine:
            return (a.reshape(geom.r, geom.s, geom.c),
                    b.reshape(geom.r, geom.s, geom.c))
        return apply(x, a, b, geom)

    @staticmethod
    def backward(ctx, *grads):
        x, weight, mom = ctx.saved_tensors
        geom = ctx.geom
        if ctx.return_affine:
            dy = None
            sums = tuple(g.reshape(geom.g, 1, geom.c).to(mom.dtype)
                         for g in grads)
        else:
            dy = grads[0].contiguous() if x.is_cuda else grads[0]
            sums = slab_views(grad_sums(dy, x, geom))
        dweight, dbias, coef = grad_finalize(sums, mom, weight, geom, ctx.eps)
        if ctx.reduce_moments is not None:
            coef[1:] = ctx.reduce_moments(coef[1:])
        dx_ = dx(dy, x, coef, geom) if ctx.needs_input_grad[0] else None
        return (dx_, dweight, dbias) + (None,) * 7


def grouped_bn_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running, geom: Geom, unbias: float,
                     momentum: float, eps: float,
                     reduce_moments: Optional[Callable] = None,
                     return_affine: bool = False):
    """Train-mode grouped BN of x (module docstring): y in x's dtype, or
    (a, b) (R, S, C) float32 with ``return_affine``. ``running`` is the
    (mean, var) buffer pair to fold replica 0's moments into, or None;
    ``unbias`` the running variance's count / (count - 1)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return _GroupedBNTrain.apply(x, weight, bias, running, geom, unbias,
                                 momentum, eps, reduce_moments,
                                 return_affine)
