"""The stage-boundary prototype as a hand-written CUDA kernel
(``csrc/tpool_proto.cu``), for the kernel tools.

    out = maxpool_t(k=3, s=2, pad=1)( relu( round(y * a + b) + ident ) )

y, ident: (N, F, H, W, C); a, b: (C,) float32 per-channel affine. z = y*a + b
is computed in float32 and rounded to y's dtype before the residual add,
which rounds again; (F + 1) // 2 output frames.

Replaces the Pallas kernel ``_pool_kernel`` (``tools/bench_tpool.py:53``,
launched by ``tpool_pallas``), the round-3 prototype of the fused epilogue
(``ops/kernels/tpool_fused.py`` is the one the model runs). Bound by device
memory on the card. A CPU tensor takes ``reference_impl``; a CUDA tensor
launches the kernel or the call raises. No gradient: the prototype is
timed, not trained.
"""

from __future__ import annotations

import ctypes

import torch

from ..temporal import temporal_pool
from . import build

KERNEL = "tpool_proto"

# launches of the CUDA kernel; a run sets it to 0 and reads it
launch_counts = {KERNEL: 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def affine_relu_add(y: torch.Tensor, ident: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """relu(round(y*a + b) + ident) in y's dtype (``_affine_relu_add``,
    bench_tpool.py:31-33)."""
    z = y.float() * a.float() + b.float()
    return torch.relu(z.to(y.dtype) + ident)


def reference_impl(y: torch.Tensor, ident: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, the program text of ``_pool_kernel``."""
    return temporal_pool(affine_relu_add(y, ident, a, b), 3, 2, "max")


def check_args(y: torch.Tensor, ident: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if y.dim() != 5 or tuple(ident.shape) != tuple(y.shape):
        raise ValueError(f"y and ident must be (N, F, H, W, C) of one shape, "
                         f"got {tuple(y.shape)} and {tuple(ident.shape)}")
    if y.dtype not in _DTYPE_CODE or ident.dtype != y.dtype:
        raise ValueError(f"y and ident must share a dtype in "
                         f"{list(_DTYPE_CODE)}, got {y.dtype}, {ident.dtype}")
    n, f, h, w, c = y.shape
    for name, t in (("a", a), ("b", b)):
        if tuple(t.shape) != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({c},), got "
                             f"{tuple(t.shape)} {t.dtype}")
    if n * f * h * w == 0:
        raise ValueError(f"empty input: y {tuple(y.shape)}")
    if c % 8:
        raise ValueError(f"need C % 8 == 0, got C={c}")
    for name, t in (("y", y), ("ident", ident), ("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if n * h * w * (c // 8) >= 2 ** 31 * 256:
        raise ValueError(f"too many threads for one launch: {tuple(y.shape)}")


def _load():
    lib = build.load_library(KERNEL)
    if lib.tpool_proto_error_string.restype is ctypes.c_char_p:
        return lib
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tpool_proto_fwd.argtypes = [vp] * 5 + [i, ll, i, ll, i, vp]
    lib.tpool_proto_fwd.restype = i
    lib.tpool_proto_error_string.argtypes = [i]
    lib.tpool_proto_error_string.restype = ctypes.c_char_p
    return lib


def _launch(y, ident, a, b) -> torch.Tensor:
    if any(t.device != y.device for t in (ident, a, b)):
        raise ValueError("all operands must be on one CUDA device")
    check_args(y, ident, a, b)
    lib = _load()
    n, f, h, w, c = y.shape
    out = torch.empty((n, (f + 1) // 2, h, w, c), dtype=y.dtype,
                      device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.tpool_proto_fwd(
            y.data_ptr(), ident.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[y.dtype], n, f, h * w, c, stream)
    if err != 0:
        msg = lib.tpool_proto_error_string(err).decode()
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} ({msg})")
    launch_counts[KERNEL] += 1
    return out


def tpool_proto(y: torch.Tensor, ident: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """relu(round(y*a + b) + ident) -> temporal max-pool, fused. Returns
    (N, (F+1)//2, H, W, C) in y.dtype. CUDA tensors run the kernel; CPU
    tensors ``reference_impl``."""
    if y.is_cuda:
        return _launch(y, ident, a, b)
    if y.device.type == "cpu":
        return reference_impl(y, ident, a, b)
    raise ValueError(f"unsupported device {y.device}")
