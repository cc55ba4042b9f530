"""ResNet TSN backbone (``adamml_tpu/models/resnet_tsn.py``).

A 2D ResNet applied per frame, frames folded into the batch, with temporal
pooling after stages 1-3 (reference models/resnet.py:116-241). Activations
are NHWC (N*F, H, W, C); a stage-boundary tensor viewed as (N, F, H, W, C)
is the row-major layout the fused epilogue kernel reads, with no copy.
In train mode every BN takes per-segment moments (``seq_groups`` = S
segments folded clip-major into the batch, ``seq_inner`` = the frame count
at that layer), per replica group with ``bn_groups`` R > 1 (the JAX
package's per-shard BN of a one-process data mesh), so the fused kernel
gets a grouped (R, S, C) affine.

Module and parameter names follow the flax tree (conv1, bn1,
layer{stage}_{block}/cb1/conv, ...), so ckpt/flax_convert.py is a direct
path mapping.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..ops.dropout import dropout
from ..ops.kernels.tpool_fused import fused_bn_add_relu_tpool
from ..ops.temporal import temporal_pool
from .layers import Conv, Conv3d, Dense, max_pool_3x3_s2
from .norm import GroupedBatchNorm
from .remat import remat, remat_active

# depth -> (block kind, per-stage counts); reference models/resnet.py:123-129
RESNET_LAYERS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class _ConvBN(nn.Module):
    """Conv then train- or eval-mode BN. A (kt, kh, kw) ``kernel`` with
    (st, sh, sw) ``strides`` makes the conv a ``Conv3d`` over
    (N, T, H, W, C) clips (models/slowfast.py)."""

    def __init__(self, in_features: int, features: int, kernel,
                 strides=1, dtype: torch.dtype = torch.float32,
                 bn_groups: int = 1):
        super().__init__()
        self.conv = (Conv3d(in_features, features, kernel, strides, dtype)
                     if isinstance(kernel, tuple) else
                     Conv(in_features, features, kernel, strides,
                          dtype=dtype))
        self.bn = GroupedBatchNorm(features, dtype=dtype, groups=bn_groups)

    def forward(self, x, train: bool, defer_affine: bool = False,
                seq_groups: int = 1, seq_inner: int = 1):
        """``defer_affine``: return (conv_out, a, b) so the caller can fuse
        the normalize into the epilogue kernel."""
        x = self.conv(x)
        if defer_affine:
            a, b = self.bn(x, train, True, seq_groups, seq_inner)
            return x, a, b
        return self.bn(x, train, False, seq_groups, seq_inner)


class BasicBlock(nn.Module):
    """reference models/resnet.py:46-74"""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, strides: int,
                 downsample: bool, dtype: torch.dtype, bn_groups: int = 1):
        super().__init__()
        self.cb1 = _ConvBN(inplanes, planes, 3, strides, dtype, bn_groups)
        self.cb2 = _ConvBN(planes, planes, 3, 1, dtype, bn_groups)
        self.downsample = (_ConvBN(inplanes, planes, 1, strides, dtype,
                                   bn_groups) if downsample else None)

    def forward(self, x, train: bool, defer_epilogue: bool = False,
                seq_groups: int = 1, seq_inner: int = 1):
        """``defer_epilogue``: return (conv_out, identity, a, b) instead of
        relu(bn(conv_out) + identity)."""
        seq = (seq_groups, seq_inner)
        identity = x
        out = torch.relu(self.cb1(x, train, False, *seq))
        if self.downsample is not None:
            identity = self.downsample(x, train, False, *seq)
        if defer_epilogue:
            out, a, b = self.cb2(out, train, True, *seq)
            return out, identity, a, b
        return torch.relu(self.cb2(out, train, False, *seq) + identity)


class Bottleneck(nn.Module):
    """reference models/resnet.py:77-113. With ``temporal_kernel`` kt the
    3D bottleneck of SlowFast (models/slowfast.py): [kt, 1, 1], then
    [1, 3, 3] with the spatial stride, then [1, 1, 1], over
    (N, T, H, W, C) clips."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, strides: int,
                 downsample: bool, dtype: torch.dtype, bn_groups: int = 1,
                 temporal_kernel: Optional[int] = None):
        super().__init__()
        k1, k3, k2, s = 1, 1, 3, strides
        if temporal_kernel is not None:
            k1, k3 = (temporal_kernel, 1, 1), (1, 1, 1)
            k2, s = (1, 3, 3), (1, strides, strides)
        self.cb1 = _ConvBN(inplanes, planes, k1, 1, dtype, bn_groups)
        self.cb2 = _ConvBN(planes, planes, k2, s, dtype, bn_groups)
        self.cb3 = _ConvBN(planes, planes * 4, k3, 1, dtype, bn_groups)
        self.downsample = (_ConvBN(inplanes, planes * 4, k3, s, dtype,
                                   bn_groups) if downsample else None)

    def forward(self, x, train: bool, defer_epilogue: bool = False,
                seq_groups: int = 1, seq_inner: int = 1):
        seq = (seq_groups, seq_inner)
        identity = x
        out = torch.relu(self.cb1(x, train, False, *seq))
        out = torch.relu(self.cb2(out, train, False, *seq))
        if self.downsample is not None:
            identity = self.downsample(x, train, False, *seq)
        if defer_epilogue:
            out, a, b = self.cb3(out, train, True, *seq)
            return out, identity, a, b
        return torch.relu(self.cb3(out, train, False, *seq) + identity)


class ResNetTSN(nn.Module):
    """Frame-folded 2D ResNet with temporal pooling between stages.

    Input (N, F, H, W, C); ``forward`` returns frame-averaged logits (N, K)
    in float32, ``features=True`` the final map (N, F_out, h, w, c).
    ``head=False`` builds no classifier (the flax module creates ``fc`` only
    when the logits are asked for).
    """

    def __init__(self, depth: int = 50, num_classes: int = 1000,
                 dropout: float = 0.5, without_t_stride: bool = False,
                 pooling_method: str = "max",
                 dtype: torch.dtype = torch.float32, fused_tpool: bool = True,
                 input_channels: int = 3, head: bool = True,
                 remat: bool = False, remat_stages: Sequence[int] = (),
                 bn_groups: int = 1):
        super().__init__()
        kind, layers = RESNET_LAYERS[depth]
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        self.depth = depth
        self.dropout = dropout
        self.without_t_stride = without_t_stride
        self.pooling_method = pooling_method
        self.dtype = dtype
        self.fused_tpool = fused_tpool
        self.bn_groups = bn_groups
        # blocks whose activations are recomputed in the backward
        # (models/remat.py): every stage, or the 1-based stages listed
        self.remat = remat
        self.remat_stages = tuple(remat_stages)
        self.conv1 = Conv(input_channels, 64, 7, 2, dtype=dtype)
        self.bn1 = GroupedBatchNorm(64, dtype=dtype, groups=bn_groups)
        self.stage_blocks: List[List[str]] = []
        inplanes = 64
        for stage, blocks in enumerate(layers):
            planes = 64 * (2 ** stage)
            strides = 1 if stage == 0 else 2
            names = []
            for b in range(blocks):
                needs_ds = b == 0 and (strides != 1 or
                                       inplanes != planes * block_cls.expansion)
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block_cls(
                    inplanes, planes, strides if b == 0 else 1, needs_ds,
                    dtype, bn_groups))
                names.append(name)
                inplanes = planes * block_cls.expansion
            self.stage_blocks.append(names)
        self.fc = Dense(self.feature_dim, num_classes, dtype) if head else None

    @property
    def feature_dim(self) -> int:
        return 2048 if self.depth >= 50 else 512

    def forward(self, x: torch.Tensor, train: bool = False,
                features: bool = False, seq_groups: int = 1,
                generator: Optional[torch.Generator] = None):
        """``seq_groups``: segments folded clip-major into the batch (the
        AdaMML wrapper passes S): train-mode BN moments are per segment, and
        the fuse gate needs whole segment cycles. ``generator`` draws the
        head's dropout mask in train mode."""
        n, f, h, w, c = x.shape

        def fold(t):
            return t.reshape((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))

        def unfold(t, frames):
            return t.reshape((-1, frames) + tuple(t.shape[1:]))

        x = fold(x.to(self.dtype))
        x = torch.relu(self.bn1(self.conv1(x), train, False, seq_groups, f))
        x = max_pool_3x3_s2(x)

        cur_frames = f
        for stage, names in enumerate(self.stage_blocks):
            pool_here = (stage < 3 and not self.without_t_stride
                         and cur_frames > 1)
            # the last block's bn-apply + add + relu fuse with the temporal
            # pool into one kernel; grouped rows must split into whole
            # segment cycles for the per-row affine lookup
            n_clips = x.shape[0] // cur_frames
            total_groups = max(1, self.bn_groups) * max(1, seq_groups)
            fuse_pool = (pool_here and self.fused_tpool
                         and self.pooling_method == "max"
                         and (total_groups <= 1
                              or (x.shape[0] % total_groups == 0
                                  and n_clips % total_groups == 0)))
            rematted = remat_active(
                self.remat or stage + 1 in self.remat_stages, train)
            for i, name in enumerate(names):
                blk = getattr(self, name)
                defer = fuse_pool and i == len(names) - 1
                run = functools.partial(blk, train=train, defer_epilogue=defer,
                                        seq_groups=seq_groups,
                                        seq_inner=cur_frames)
                out = remat(blk, run, x) if rematted else run(x)
                if defer:
                    y, ident, aff_a, aff_b = out
                    x = fused_bn_add_relu_tpool(
                        unfold(y, cur_frames).contiguous(),
                        unfold(ident, cur_frames).contiguous(), aff_a, aff_b)
                    cur_frames = x.shape[1]
                    x = fold(x)
                else:
                    x = out
            # temporal pooling after layers 1-3 (reference models/resnet.py:145-154)
            if pool_here and not fuse_pool:
                x = temporal_pool(unfold(x, cur_frames), 3, 2,
                                  self.pooling_method)
                cur_frames = x.shape[1]
                x = fold(x)

        if features:
            return unfold(x, cur_frames)

        x = x.mean(dim=(1, 2))  # global average pool
        x = dropout(x, self.dropout, train, generator)
        x = self.fc(x)
        x = unfold(x, cur_frames)  # (N, F_out, K)
        return x.mean(dim=1).float()
