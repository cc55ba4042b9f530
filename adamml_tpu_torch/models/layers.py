"""Conv and Dense with flax's ``dtype=`` semantics, over channels-last data.

Parameters stay float32; input and weight are cast to the compute dtype at
use, and the result is in that dtype. Activations are NHWC tensors
(B, H, W, C) as in the JAX package: ``x.permute(0, 3, 1, 2)`` of a
contiguous NHWC tensor is already a channels_last NCHW tensor, so the
convolution reads and writes it in place and no layout copy happens.
``Conv3d`` does the same over (B, T, H, W, C) video tensors, whose
permute is a ``channels_last_3d`` NCDHW tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import Shard, column_parallel_linear, param_shard


class Conv(nn.Module):
    """flax ``nn.Conv`` (no bias, symmetric k//2 padding) on NHWC tensors.
    ``weight`` is (O, I/groups, kh, kw)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 strides: int = 1, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, kernel, kernel))
        self.strides = strides
        self.padding = kernel // 2
        self.groups = groups
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.weight.to(self.dtype), stride=self.strides,
                     padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class Conv3d(nn.Module):
    """A 3D convolution on (B, T, H, W, C) tensors: ``kernel`` (kt, kh, kw)
    padded by k // 2 on each axis, ``strides`` (st, sh, sw) or one stride
    for all three, a bias only with ``bias=True``. ``weight`` is (O,
    I / groups, kt, kh, kw). A grouped convolution (``groups`` > 1; ``groups``
    = C: depthwise) takes channels-first input through ``ncdhw`` alone. A
    kernel and stride of 1 in time is the 2D convolution of every
    frame, so it runs as one, frames folded into the batch (the same sums,
    on the 2D channels-last kernels: a SlowFast 8x8 train step of 64 clips
    took 320.6 ms this way against 323.2 ms with ``F.conv3d`` for every
    kernel on an H100)."""

    def __init__(self, in_features: int, features: int, kernel: tuple,
                 strides=1, dtype: torch.dtype = torch.float32,
                 groups: int = 1, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features,
                                               in_features // groups,
                                               *kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.strides = (tuple(strides) if isinstance(strides, tuple)
                        else (strides,) * 3)
        self.padding = tuple(k // 2 for k in kernel)
        self.groups = groups
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        x = x.to(self.dtype)
        if self.groups != 1:
            raise ValueError("a grouped Conv3d takes channels-first input: "
                             "call Conv3d.ncdhw")
        if w.shape[2] == 1 and self.strides[0] == 1:
            n, t = x.shape[:2]
            y = F.conv2d(x.reshape((n * t,) + tuple(x.shape[2:]))
                         .permute(0, 3, 1, 2), w.squeeze(2), b,
                         stride=self.strides[1:], padding=self.padding[1:])
            y = y.permute(0, 2, 3, 1)
            return y.reshape((n, t) + tuple(y.shape[1:]))
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, stride=self.strides,
                     padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)

    def ncdhw(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution of a contiguous (B, C, T, H, W) tensor, grouped
        or not. A depthwise convolution runs there on aten's native
        depthwise 3D kernels (``conv_depthwise3d``), and on channels-last
        input on cuDNN's generic ``implicit_convolveNd_sgemm``: at MViT's
        five pooling shapes (bf16, B x heads = 32-128, H100) channels first
        took 9-30x less time forward and 1.0-3.7x less forward and backward
        (27.15 against 7.42 ms at [32, 96, 8, 56, 56] stride 1, 2.41
        against 1.48 at [128, 96, 8, 14, 14] stride 2, 3.38 against 3.39 at
        [32, 96, 8, 56, 56] stride 8)."""
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv3d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        stride=self.strides, padding=self.padding,
                        groups=self.groups)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` (O, I), ``bias`` (O,). After
    ``shard_(shard)`` the weight holds only the shard's rows (the tensor-
    parallel column shard, parallel/mesh.py) and the layer computes the
    full output by ``column_parallel_linear``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    @property
    def shard(self) -> Optional[Shard]:
        return param_shard(self.weight)

    @torch.no_grad()
    def shard_(self, shard: Shard) -> None:
        """Keep ``shard``'s rows of the full weight."""
        self.weight = nn.Parameter(shard.rows(self.weight).clone())
        self.weight.model_shard = shard

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if self.shard is not None:
            return column_parallel_linear(x, w, self.bias.to(self.dtype),
                                          self.shard)
        return F.linear(x, w, self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, ``eps`` 1e-6, with float32 ``weight``
    and ``bias`` cast to the compute dtype at use (on a card the moments
    are taken in float32 whatever the dtype)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(self.dtype), self.weight.shape,
                            self.weight.to(self.dtype),
                            self.bias.to(self.dtype), self.eps)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool(x, (3, 3), (2, 2), padding=((1, 1), (1, 1)))`` on
    NHWC (padding never wins the max)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
