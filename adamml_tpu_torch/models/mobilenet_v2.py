"""MobileNetV2 (``adamml_tpu/models/mobilenet_v2.py``).

One module covers both reference variants:

  * the torchvision-style audio backbone over 1x256x256 log-spectrograms
    (reference models/sound_mobilenet_v2.py:72-175), and
  * the d-li14 160x160 policy trunk with temporal max-pooling before the
    first block of the c=64 and c=160 stages (reference
    models/policy_net.py:98-203): ``temporal_pooling=True``.

Activations are NHWC with frames folded into the batch. In train mode every
BN takes per-segment moments: ``seq_groups`` segments folded clip-major into
the batch, ``seq_inner`` the frame count at that layer (it halves at each
temporal pool).

``use_pallas_dw=True`` runs every 3x3 depthwise layer (17 of them, 4 at
stride 2) through the hand-written depthwise kernel, whatever its shape; as
in the JAX package this is a different function from the default, since its
padding is "SAME" rather than symmetric (``_DepthwiseConv``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import dropout
from ..ops.kernels.depthwise import depthwise_conv3x3
from ..ops.temporal import temporal_pool
from .layers import Conv, Dense
from .norm import GroupedBatchNorm

# t (expansion), c (channels), n (blocks), s (stride)
INVERTED_RESIDUAL_CFG: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

LAST_CHANNEL = 1280
TEMPORAL_POOL_CHANNELS = (64, 160)


def make_divisible(v: float, divisor: int = 8,
                   min_value: Optional[int] = None) -> int:
    """Channel rounding (reference models/sound_mobilenet_v2.py:13-30)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _DepthwiseConv(Conv):
    """3x3 depthwise conv with ``Conv``'s parameter (``weight``
    (C, 1, 3, 3), so the state dict is the same with the flag on or off)
    through the hand-written depthwise kernel (ops/kernels/depthwise.py),
    which pads XLA's "SAME" way: (0, 1) at stride 2 on an even size, where
    ``Conv`` pads (1, 1). The weight is cast to the activations' dtype
    first, as the JAX module does."""

    def __init__(self, features: int, strides: int, dtype: torch.dtype):
        super().__init__(features, features, 3, strides, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)[:, 0].permute(1, 2, 0)  # (3, 3, C)
        return depthwise_conv3x3(x.contiguous(), w, stride=self.strides)


class _ConvBNReLU6(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1, groups: int = 1,
                 dtype: torch.dtype = torch.float32,
                 use_pallas_dw: bool = False, bn_groups: int = 1):
        super().__init__()
        if (use_pallas_dw and groups > 1 and groups == features
                and kernel == 3):
            self.conv = _DepthwiseConv(features, strides, dtype)
        else:
            self.conv = Conv(in_features, features, kernel, strides, groups,
                             dtype)
        self.bn = GroupedBatchNorm(features, dtype=dtype, groups=bn_groups)

    def forward(self, x, train: bool, seq_groups: int = 1,
                seq_inner: int = 1):
        # relu6's gradient is 0 at 0 and at 6, as jax.nn.relu6's is
        # (torch.clamp's is 1 there)
        return F.relu6(self.bn(self.conv(x), train, False, seq_groups,
                               seq_inner))


class InvertedResidual(nn.Module):
    """reference models/sound_mobilenet_v2.py:43-69"""

    def __init__(self, inp: int, features: int, strides: int,
                 expand_ratio: int, dtype: torch.dtype,
                 use_pallas_dw: bool = False, bn_groups: int = 1):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = strides == 1 and inp == features
        self.pw = (_ConvBNReLU6(inp, hidden, 1, 1, dtype=dtype,
                                bn_groups=bn_groups)
                   if expand_ratio != 1 else None)
        self.dw = _ConvBNReLU6(hidden, hidden, 3, strides, groups=hidden,
                               dtype=dtype, use_pallas_dw=use_pallas_dw,
                               bn_groups=bn_groups)
        self.pw_linear = Conv(hidden, features, 1, dtype=dtype)
        self.bn_linear = GroupedBatchNorm(features, dtype=dtype,
                                          groups=bn_groups)

    def forward(self, x, train: bool, seq_groups: int = 1,
                seq_inner: int = 1):
        seq = (seq_groups, seq_inner)
        out = x if self.pw is None else self.pw(x, train, *seq)
        out = self.dw(out, train, *seq)
        out = self.bn_linear(self.pw_linear(out), train, False, *seq)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    """Input (N, F, H, W, C); frames fold into the batch around the convs.

    ``forward`` returns frame-averaged logits (N, K) in float32;
    ``features=True`` returns pooled per-frame embeddings
    (N, F_out, last_channel). ``head=False`` builds no classifier (the flax
    module creates one only when the logits are asked for).
    """

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 dropout: float = 0.5, temporal_pooling: bool = False,
                 use_pallas_dw: bool = False,
                 dtype: torch.dtype = torch.float32, input_channels: int = 1,
                 head: bool = True, bn_groups: int = 1):
        super().__init__()
        self.dropout = dropout
        self.temporal_pooling = temporal_pooling
        self.dtype = dtype
        self.last_channel = make_divisible(LAST_CHANNEL * max(1.0, width_mult))
        inp = make_divisible(32 * width_mult)
        self.features_0 = _ConvBNReLU6(input_channels, inp, 3, 2, dtype=dtype,
                                       bn_groups=bn_groups)
        # (block name, output channels, whether a temporal pool precedes it)
        self.blocks = []
        idx = 1
        for t, ch, nblocks, s in INVERTED_RESIDUAL_CFG:
            out_ch = make_divisible(ch * width_mult)
            for i in range(nblocks):
                name = f"features_{idx}"
                self.add_module(name, InvertedResidual(
                    inp, out_ch, s if i == 0 else 1, t, dtype,
                    use_pallas_dw=use_pallas_dw, bn_groups=bn_groups))
                self.blocks.append(
                    (name, i == 0 and ch in TEMPORAL_POOL_CHANNELS))
                inp = out_ch
                idx += 1
        self.conv_last = _ConvBNReLU6(inp, self.last_channel, 1, 1,
                                      dtype=dtype, bn_groups=bn_groups)
        self.classifier = (Dense(self.last_channel, num_classes, dtype)
                           if head else None)

    def forward(self, x: torch.Tensor, train: bool = False,
                features: bool = False, seq_groups: int = 1,
                generator: Optional[torch.Generator] = None):
        """``seq_groups``: segments folded clip-major into the batch (the
        AdaMML wrapper passes S); ``generator`` draws the classifier's
        dropout mask in train mode."""
        n, f, h, w, c = x.shape
        x = x.to(self.dtype).reshape(n * f, h, w, c)
        x = self.features_0(x, train, seq_groups, f)
        cur_frames = f
        for name, pool_before in self.blocks:
            if self.temporal_pooling and pool_before and cur_frames > 1:
                x = x.reshape((n, cur_frames) + tuple(x.shape[1:]))
                x = temporal_pool(x, 3, 2, "max")
                cur_frames = x.shape[1]
                x = x.reshape((n * cur_frames,) + tuple(x.shape[2:]))
            x = getattr(self, name)(x, train, seq_groups, cur_frames)
        x = self.conv_last(x, train, seq_groups, cur_frames)
        x = x.mean(dim=(1, 2))  # (N*F_out, last_channel)
        if features:
            return x.reshape(n, cur_frames, self.last_channel)
        x = dropout(x, self.dropout, train, generator)
        x = self.classifier(x).reshape(n, cur_frames, -1)
        return x.mean(dim=1).float()
