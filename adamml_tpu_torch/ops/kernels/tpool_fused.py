"""Fused stage-boundary epilogue: BN-apply + residual-add + ReLU + temporal
max-pool, forward and backward, as hand-written CUDA kernels
(``csrc/tpool_fused.cu``, ``csrc/tpool_fused_bwd.cu``).

    out = maxpool_t(k=3, s=2, pad=1)( relu( y * a[g] + b[g] + ident ) )

y, ident: (N, F, H, W, C), leading axis (clips, segments)-ordered; a, b:
(R, S, C) float32 grouped BN affine, row n taking group
g = (n // (N/R)) * S + n % S (R = S = 1 is the eval-mode affine). All math
in float32, one rounding at the end to y's dtype.

The backward recomputes pre = y*a[g] + b[g] + ident, routes each pooled
cotangent to the FIRST maximum of its window (``lax.reduce_window``'s VJP),
masks by pre > 0 and gives dident = dpre (rounded to ident's dtype),
dy = dident * a[g] (from the rounded dpre, as the JAX package's
``_pallas_bwd`` does) and (da, db) = per-group sums of (dpre * y, dpre)
taken from the unrounded float32 dpre.

Replaces the Pallas kernels of ``adamml_tpu/ops/pallas/tpool_fused.py``:
forward ``_kernel`` (line 71) and ``_kernel_hwnfc`` (line 345), backward
``_bwd_kernel`` (line 92) and ``_bwd_kernel_hwnfc`` (line 402). Both are
bound by device memory on the card.

``fused_bn_add_relu_tpool`` is a ``torch.autograd.Function``: a CPU tensor
takes ``reference_impl`` and ``reference_bwd``, the plain PyTorch versions;
a CUDA tensor launches the kernels or the call raises. ``bwd_plan`` is the
backward kernel's launch plan (blocks, pixel chunks, the ring, scratch and
the order in which it sums), made here so that the CPU tests can check it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..temporal import out_frames, temporal_pool
from . import build

KERNEL = "tpool_fused"
KERNEL_BWD = "tpool_fused_bwd"

# launches of the CUDA kernels, by wrapper (the counterpart of the JAX
# module's trace_counts); a run sets them to 0 and reads them to show that
# its path went through the kernels
launch_counts = {KERNEL: 0, KERNEL_BWD: 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _grouped(t: torch.Tensor, r: int, s: int) -> torch.Tensor:
    """(N, ...) float32 view as (R, clips per group, S, ...)."""
    n = t.shape[0]
    return t.float().reshape((r, n // (r * s), s) + tuple(t.shape[1:]))


def _pre(y, ident, a, b):
    """pre = y * a[g] + b[g] + ident in float32, (N, F, H, W, C)."""
    r, s, c = a.shape
    bshape = (r, 1, s, 1, 1, 1, c)
    z = _grouped(y, r, s) * a.float().reshape(bshape) + b.float().reshape(
        bshape)
    return z.reshape(y.shape) + ident.float()


def reference_impl(y: torch.Tensor, ident: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward (float32 throughout, one cast at the end)."""
    return temporal_pool(torch.relu(_pre(y, ident, a, b)), 3, 2,
                         "max").to(y.dtype)


def routed_dpre(y: torch.Tensor, ident: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """The unrounded float32 dpre (N, F, H, W, C) for the cotangent ct: ct
    routed to the first maximum of each window, masked by pre > 0. The
    routing is written out: autograd through a max would not send a tie to
    the first maximum."""
    f = y.shape[1]
    pre = _pre(y, ident, a, b)
    z = torch.relu(pre)
    ctf = ct.float()
    dz = torch.zeros_like(pre)
    for fo in range(out_frames(f)):
        lo, hi = max(0, 2 * fo - 1), min(f, 2 * fo + 2)
        m = z[:, lo]
        for k in range(lo + 1, hi):
            m = torch.maximum(m, z[:, k])
        taken = torch.zeros_like(m, dtype=torch.bool)
        for k in range(lo, hi):
            sel = (z[:, k] == m) & ~taken
            taken |= sel
            dz[:, k] += torch.where(sel, ctf[:, fo], 0.0)
    return torch.where(pre > 0, dz, 0.0)


def reference_bwd(y: torch.Tensor, ident: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, ct: torch.Tensor):
    """Plain PyTorch backward: (dy, dident, da, db) for the cotangent ct
    (N, F_out, H, W, C)."""
    r, s, c = a.shape
    dpre = routed_dpre(y, ident, a, b, ct)
    dident = dpre.to(ident.dtype)
    bshape = (r, 1, s, 1, 1, 1, c)
    dy = (_grouped(dident, r, s) * a.float().reshape(bshape)).reshape(
        y.shape).to(y.dtype)
    sums = torch.stack([(dpre * y.float()).sum(dim=(1, 2, 3)),
                        dpre.sum(dim=(1, 2, 3))], dim=1)      # (N, 2, C)
    return (dy, dident) + _group_sums(sums, r, s)


def planned_row_sums(dpre: torch.Tensor, y: torch.Tensor,
                     plan: dict) -> torch.Tensor:
    """Per-row (N, 2, C) float32 sums of (dpre * y, dpre), added in the
    backward kernel's order for ``plan`` (``bwd_plan``): each pixel lane
    over its pixels in order and, per pixel, frames 0..F-1; then the lanes
    in the tree ((l0+l2)+(l1+l3))+((l4+l6)+(l5+l7)) (two warp shuffles in
    each half of the block, then the halves); then the chunks in index
    order. The plain version of the kernel's rows, bit for bit, on the
    CPU."""
    n, f, h, w, c = dpre.shape
    hw = h * w
    d = dpre.float().reshape(n, f, hw, c)
    yv = y.float().reshape(n, f, hw, c)
    lanes, chunks, cp = plan["order"]
    rows = None
    for k in range(chunks):
        lane_sums = []
        for lane in range(lanes):
            sy = torch.zeros((n, c))
            s1 = torch.zeros((n, c))
            for px in range(k * cp + lane, min((k + 1) * cp, hw), lanes):
                for fr in range(f):
                    sy = sy + d[:, fr, px] * yv[:, fr, px]
                    s1 = s1 + d[:, fr, px]
            lane_sums.append(torch.stack([sy, s1], dim=1))
        v = [lane_sums[i] + lane_sums[i + 2] for i in (0, 1, 4, 5)]
        v = [v[0] + v[1], v[2] + v[3]]
        rows = v[0] + v[1] if rows is None else rows + (v[0] + v[1])
    return rows


def _group_sums(dab: torch.Tensor, r: int, s: int):
    """Per-row (N, 2, C) partials -> (da, db), each (R, S, C)."""
    n, _, c = dab.shape
    part = dab.reshape(r, n // (r * s), s, 2, c).sum(dim=1)
    return part[:, :, 0], part[:, :, 1]


def check_args(y: torch.Tensor, ident: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, ct: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError on anything the kernels do not take; ``ct`` is the
    backward's cotangent."""
    if y.dim() != 5 or tuple(ident.shape) != tuple(y.shape):
        raise ValueError(f"y and ident must be (N, F, H, W, C) of one shape, "
                         f"got {tuple(y.shape)} and {tuple(ident.shape)}")
    if y.dtype not in _DTYPE_CODE or ident.dtype != y.dtype:
        raise ValueError(f"y and ident must share a dtype in "
                         f"{list(_DTYPE_CODE)}, got {y.dtype}, {ident.dtype}")
    n, f, h, w, c = y.shape
    if (a.dim() != 3 or tuple(b.shape) != tuple(a.shape)
            or a.shape[2] != c):
        raise ValueError(f"a and b must be (R, S, C={c}), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"a and b must be float32, got {a.dtype}, {b.dtype}")
    r, s, _ = a.shape
    if n * h * w == 0 or r < 1 or s < 1:
        raise ValueError(f"empty input: y {tuple(y.shape)}, a {tuple(a.shape)}")
    if f < 2:
        raise ValueError(f"need F >= 2 frames, got {f}")
    if c % 8:
        raise ValueError(f"need C % 8 == 0, got C={c}")
    if n % (r * s) or (n // r) % s:
        raise ValueError(f"rows N={n} do not split into R={r} replica "
                         f"groups of whole S={s} segment cycles")
    tensors = [("y", y), ("ident", ident), ("a", a), ("b", b)]
    if ct is not None:
        want = (n, out_frames(f), h, w, c)
        if tuple(ct.shape) != want or ct.dtype != y.dtype:
            raise ValueError(f"ct must be {want} in {y.dtype}, got "
                             f"{tuple(ct.shape)} in {ct.dtype}")
        tensors.append(("ct", ct))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if n * h * w * (c // 8) >= 2 ** 31 * 256:
        raise ValueError(f"too many threads for one launch: {tuple(y.shape)}")


# the backward kernel's fixed shape (csrc/tpool_fused_bwd.cu): 256 threads
# of 8 pixel lanes by 32 channel groups of 16 bytes (a warp: 4 lanes x 8
# groups); a ring of 4 steps of 5 pieces of 16 bytes a thread in shared
# memory; two blocks an SM
BWD_THREADS = 256
BWD_LANES = 8
BWD_STAGES = 4
BWD_PIECE = 16
BWD_SMEM = BWD_STAGES * 5 * BWD_THREADS * BWD_PIECE
BWD_BLOCKS_PER_SM = 2
# the partials may add this share of the bytes the bound counts, written
# and read: 1/50
BWD_PARTIALS_SHARE = 50
# a chunk gives each pixel lane at least this many pixels
BWD_LANE_PIXELS_MIN = 3
# slice groups are added until the blocks fill this many rounds of the
# card's resident blocks
BWD_ROUNDS = 4
H100_SMS = 132


def bwd_plan(n: int, f: int, h: int, w: int, c: int, itemsize: int = 2,
             sms: int = H100_SMS, *, chunks: Optional[int] = None,
             slice_groups: Optional[int] = None) -> dict:
    """The backward kernel's launch plan for y of (n, f, h, w, c) with
    ``itemsize``-byte elements on a card of ``sms`` SMs.

    A block owns one (row, pixel chunk, slice group). Its 256 threads are
    8 pixel lanes (lane l takes the chunk's pixels l, l + 8, ...) by 32
    channel groups of ``vec`` channels, a channel slice; it walks the
    slices g, g + slice_groups, ... of its group g. Small blocks run best
    (the card schedules them evenly), so a row has as many chunks as keep
    the f32 partials, written and read, within 1/50 of the bytes the bound
    counts, of at least 3 pixels a lane; when the chunks alone give fewer
    than 4 rounds of the card's resident blocks, the slices are split into
    groups. With one chunk a row the kernel writes the row's sums itself
    (no partials, no tickets). The chunks depend on (n, f, h, w) and the
    dtype, never on c, so the order in which a channel's terms are added,
    ``order`` (lanes, chunks, chunk pixels), is the same for every c and
    every channel slice. ``chunks`` and ``slice_groups`` replace the
    rule's choices (``tools/bench_tpool_bwd.py`` times other plans)."""
    hw = h * w
    fo = out_frames(f)
    vec = BWD_PIECE // itemsize
    groups = c // vec
    slices = -(-groups // (BWD_THREADS // BWD_LANES))
    by_partials = (4 * f + fo) * hw * itemsize // (16 * BWD_PARTIALS_SHARE)
    by_pixels = -(-hw // (BWD_LANES * BWD_LANE_PIXELS_MIN))
    if chunks is None:
        chunks = max(1, min(by_partials, by_pixels))
    chunk_pixels = -(-hw // chunks)
    chunks = -(-hw // chunk_pixels)
    resident = sms * BWD_BLOCKS_PER_SM
    if slice_groups is None:
        slice_groups = max(1, min(
            slices, -(-BWD_ROUNDS * resident // (n * chunks))))
    blocks = n * chunks * slice_groups
    partials = (n, chunks, 2, c) if chunks > 1 else None
    return {
        "threads": BWD_THREADS, "lanes": BWD_LANES, "vec": vec,
        "stages": BWD_STAGES, "smem_bytes": BWD_SMEM, "slices": slices,
        "slice_groups": slice_groups, "chunks": chunks,
        "chunk_pixels": chunk_pixels,
        "lane_pixels": -(-chunk_pixels // BWD_LANES),
        "blocks": blocks, "blocks_per_sm": BWD_BLOCKS_PER_SM,
        "waves": math.ceil(blocks / resident),
        "partials_shape": partials,
        "partials_bytes": 2 * math.prod(partials) * 4 if partials else 0,
        "tickets": n if partials else 0,
        "kernels": 1,
        "order": (BWD_LANES, chunks, chunk_pixels)}


def _load(name: str):
    """The library of ``csrc/<name>.cu`` with its C signatures declared."""
    lib = build.load_library(name)
    if lib.tpool_fused_error_string.restype is ctypes.c_char_p:
        return lib
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == KERNEL:
        lib.tpool_fused_fwd.argtypes = [vp] * 5 + [i, ll, i, ll, i, i, i, vp]
        lib.tpool_fused_fwd.restype = i
    else:
        lib.tpool_fused_bwd.argtypes = ([vp] * 10 + [i, ll, i, ll, i, i, i]
                                        + [i] * 10 + [vp])
        lib.tpool_fused_bwd.restype = i
    lib.tpool_fused_error_string.argtypes = [i]
    lib.tpool_fused_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        msg = lib.tpool_fused_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _same_device(*tensors) -> None:
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("all operands must be on one CUDA device")


def _launch(y, ident, a, b):
    _same_device(y, ident, a, b)
    check_args(y, ident, a, b)
    lib = _load(KERNEL)
    n, f, h, w, c = y.shape
    r, s, _ = a.shape
    out = torch.empty((n, out_frames(f), h, w, c), dtype=y.dtype,
                      device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.tpool_fused_fwd(
            y.data_ptr(), ident.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[y.dtype], n, f, h * w, c, r, s,
            stream)
    _raise_on(lib, KERNEL, err)
    launch_counts[KERNEL] += 1
    return out


def _launch_bwd(y, ident, a, b, ct):
    """(dy, dident, da, db) from the backward kernel; the per-group sum of
    its per-row sums is plain PyTorch."""
    dy, dident, dab = _launch_bwd_rows(y, ident, a, b, ct)
    r, s, _ = a.shape
    return (dy, dident) + _group_sums(dab, r, s)


def _launch_bwd_rows(y, ident, a, b, ct, plan: Optional[dict] = None):
    """(dy, dident, per-row (N, 2, C) sums) from the backward kernel,
    launched on ``plan``, by default ``bwd_plan``'s (through per-chunk
    partials and per-row tickets when a row has several chunks: scratch
    made here)."""
    _same_device(y, ident, a, b, ct)
    check_args(y, ident, a, b, ct)
    lib = _load(KERNEL_BWD)
    n, f, h, w, c = y.shape
    r, s, _ = a.shape
    if plan is None:
        plan = bwd_plan(n, f, h, w, c, y.element_size(),
                        torch.cuda.get_device_properties(
                            y.device).multi_processor_count)
    dy, dident = torch.empty_like(y), torch.empty_like(ident)
    dab = torch.empty((n, 2, c), dtype=torch.float32, device=y.device)
    part = tickets = None
    if plan["partials_shape"] is not None:
        part = torch.empty(plan["partials_shape"], dtype=torch.float32,
                           device=y.device)
        tickets = torch.empty((n,), dtype=torch.int32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.tpool_fused_bwd(
            y.data_ptr(), ident.data_ptr(), a.data_ptr(), b.data_ptr(),
            ct.data_ptr(), dident.data_ptr(), dy.data_ptr(),
            part.data_ptr() if part is not None else None,
            tickets.data_ptr() if tickets is not None else None,
            dab.data_ptr(), _DTYPE_CODE[y.dtype], n, f, h * w, c, r, s,
            *(plan[k] for k in ("threads", "lanes", "vec", "stages",
                                "smem_bytes", "slices", "slice_groups",
                                "chunks", "chunk_pixels", "lane_pixels")),
            stream)
    _raise_on(lib, KERNEL_BWD, err)
    launch_counts[KERNEL_BWD] += 1
    return dy, dident, dab


class _FusedEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, ident, a, b):
        ctx.save_for_backward(y, ident, a, b)
        if y.is_cuda:
            return _launch(y, ident, a, b)
        return reference_impl(y, ident, a, b)

    @staticmethod
    def backward(ctx, ct):
        y, ident, a, b = ctx.saved_tensors
        return fused_bn_add_relu_tpool_bwd(y, ident, a, b, ct.contiguous())


def fused_bn_add_relu_tpool(y: torch.Tensor, ident: torch.Tensor,
                            a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(y*a[g] + b[g] + ident) -> temporal max-pool, fused, with its
    gradient to all four operands.

    Returns (N, F_out, H, W, C) in y.dtype. CUDA tensors run the kernels;
    CPU tensors run ``reference_impl`` and ``reference_bwd``."""
    if y.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {y.device}")
    return _FusedEpilogue.apply(y, ident, a, b)


def fused_bn_add_relu_tpool_bwd(y: torch.Tensor, ident: torch.Tensor,
                                a: torch.Tensor, b: torch.Tensor,
                                ct: torch.Tensor):
    """(dy, dident, da, db) of ``fused_bn_add_relu_tpool`` for the cotangent
    ct (N, F_out, H, W, C). CUDA tensors run the backward kernel; CPU
    tensors run ``reference_bwd``."""
    if y.is_cuda:
        return _launch_bwd(y, ident, a, b, ct)
    if y.device.type == "cpu":
        return reference_bwd(y, ident, a, b, ct)
    raise ValueError(f"unsupported device {y.device}")
