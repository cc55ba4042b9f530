"""SlowFast 8x8, ResNet-50 (Feichtenhofer, Fan, Malik, He, "SlowFast
Networks for Video Recognition", ICCV 2019, arXiv:1812.03982, Table 1;
PySlowFast's ``configs/Kinetics/SLOWFAST_8x8_R50.yaml``), the port's 3D
video model, over channels-last clips.

Input (N, T, H, W, 3): one clip of T frames (train_unimodal's unimodal
preprocessor folds the loader's (N, 1, T, ...) segment into time); with T
a multiple k > 1 of ``frames`` the rows hold k clips each (multi-clip
eval), whose logits are averaged.

- Two pathways. The fast one takes all T frames at 1/8 of the width
  (beta); the slow one every alpha-th (4th) frame, frames
  ``torch.linspace(0, T - 1, T // 4).long()`` (PySlowFast's
  ``PackPathway``), picked here on the device, at full width.
- Stems: conv [1, 7, 7] (slow) and [5, 7, 7] (fast) with stride (1, 2, 2),
  BN, ReLU, max-pool [1, 3, 3], stride (1, 2, 2), padding (0, 1, 1).
- Four lateral connections, fast to slow, after the stem and res2-res4:
  conv [7, 1, 1], stride (4, 1, 1), to twice the fast channels, BN, ReLU,
  concatenated after the slow channels.
- res2-res5: 3, 4, 6 and 3 3D bottlenecks (``resnet_tsn.Bottleneck`` with
  a temporal kernel: the slow pathway's first conv [1, 1, 1] in res2-res3
  and [3, 1, 1] in res4-res5, the fast pathway's [3, 1, 1] everywhere),
  the spatial stride 2 of res3-res5 on the [1, 3, 3] conv; no pooling
  between stages.
- Head: each pathway's mean over (T, H, W), concatenated (2048 + 256),
  dropout, fc. Eval mode returns the logits.

Every conv is bias-free and followed by BN (models/norm.py; in train mode
global moments over (N, T, H, W), T folded into the rows). ``init_weights``
is PySlowFast's ``init_weights``: Kaiming normal with fan-out for the
convs, BN scale 1 and bias 0 but the scale of each bottleneck's last BN 0
(``ZERO_INIT_FINAL_BN``), fc weights normal with std 0.01 and bias 0.

Spans (utils/profiling.py), forward and backward: each slow stage
(``model.slow``: the frame pick, the stem, res2-res5, the head's pooling of
its features), each fast stage (``model.fast``), each lateral connection
with its concatenation (``model.fuse``), in neither pathway's span;
``model.bn`` nests inside them.

Parameter names: ``slow.stem.{conv,bn}``, ``slow.res{2-5}_{block}.{cb1,cb2,
cb3,downsample}.{conv,bn}``, the same under ``fast.``,
``fuse.{stem,res2,res3,res4}.{conv,bn}``, ``fc``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops.dropout import dropout
from ..utils.profiling import spanned
from .layers import Conv3d, Dense, max_pool_3x3_s2
from .norm import GroupedBatchNorm
from .resnet_tsn import Bottleneck, _ConvBN

ALPHA = 4            # the slow pathway takes every ALPHA-th frame
BETA_INV = 8         # the fast pathway's channels: 1 / BETA_INV of the slow's
FUSION_RATIO = 2     # a lateral conv's channels over the fast pathway's
FUSION_KERNEL = 7    # a lateral conv's temporal kernel
BLOCKS = {50: (3, 4, 6, 3)}
# the first conv's temporal kernel in each stage's bottlenecks, res2-res5
SLOW_TEMPORAL = (1, 1, 3, 3)
FAST_TEMPORAL = (3, 3, 3, 3)
STEM_TEMPORAL = {"slow": 1, "fast": 5}
STAGE_NAMES = ("stem", "res2", "res3", "res4", "res5")


def slow_frames(t: int) -> torch.Tensor:
    """The slow pathway's frame indices among t (PySlowFast's
    ``PackPathway``)."""
    return torch.linspace(0, t - 1, t // ALPHA).long()


class _Pathway(nn.Module):
    """One pathway's stem and bottleneck stages; ``in_extra[k]`` channels
    join stage k's input from the lateral connection before it."""

    def __init__(self, name: str, width: int, blocks, temporal,
                 in_extra, dtype, bn_groups):
        super().__init__()
        self.stem = _ConvBN(3, width, (STEM_TEMPORAL[name], 7, 7),
                            (1, 2, 2), dtype, bn_groups)
        self.stage_blocks: List[List[str]] = []
        inplanes = width
        for stage, count in enumerate(blocks):
            planes = width * 2 ** stage
            names = []
            for b in range(count):
                cin = inplanes + (in_extra[stage] if b == 0 else 0)
                stride = 2 if stage > 0 and b == 0 else 1
                name_b = f"{STAGE_NAMES[stage + 1]}_{b}"
                self.add_module(name_b, Bottleneck(
                    cin, planes, stride, b == 0, dtype, bn_groups,
                    temporal_kernel=temporal[stage]))
                names.append(name_b)
                inplanes = planes * Bottleneck.expansion
            self.stage_blocks.append(names)
        self.out_channels = inplanes

    def stem_out(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = torch.relu(self.stem(x, train))
        n, t = x.shape[:2]
        x = max_pool_3x3_s2(x.reshape((n * t,) + tuple(x.shape[2:])))
        return x.reshape((n, t) + tuple(x.shape[1:]))

    def stage(self, x: torch.Tensor, k: int, train: bool,
              pool: bool) -> torch.Tensor:
        """Stage k (0: the stem, 1-4: res2-res5); ``pool`` ends with the
        head's mean over (T, H, W)."""
        if k == 0:
            return self.stem_out(x, train)
        for name in self.stage_blocks[k - 1]:
            x = getattr(self, name)(x, train)
        return x.mean(dim=(1, 2, 3)) if pool else x


class _Fuse(_ConvBN):
    """A lateral connection: conv [7, 1, 1] with temporal stride ALPHA,
    BN, ReLU, concatenated after the slow pathway's channels."""

    def __init__(self, channels: int, dtype, bn_groups):
        super().__init__(channels, channels * FUSION_RATIO,
                         (FUSION_KERNEL, 1, 1), (ALPHA, 1, 1), dtype,
                         bn_groups)

    def forward(self, fast: torch.Tensor, slow: torch.Tensor,
                train: bool) -> torch.Tensor:
        return torch.cat([slow, torch.relu(super().forward(fast, train))],
                         -1)


class SlowFast(nn.Module):
    """SlowFast over (N, T, H, W, 3) clips; ``forward`` returns float32
    logits (N, K). ``width`` is the slow pathway's stem width (64 as
    published) and ``frames`` a clip's frame count (32); the CPU tests
    build smaller ones."""

    def __init__(self, depth: int = 50, num_classes: int = 400,
                 dropout: float = 0.5, width: int = 64, frames: int = 32,
                 dtype: torch.dtype = torch.float32, bn_groups: int = 1):
        super().__init__()
        if depth not in BLOCKS:
            raise ValueError(f"SlowFast has depth {sorted(BLOCKS)}, not "
                             f"{depth}")
        if frames % ALPHA or width % BETA_INV:
            raise ValueError(f"frames {frames} must divide by {ALPHA} and "
                             f"width {width} by {BETA_INV}")
        blocks = BLOCKS[depth]
        fast_w = width // BETA_INV
        fast_out = [fast_w] + [fast_w * 2 ** k * Bottleneck.expansion
                               for k in range(3)]
        self.dropout, self.frames, self.dtype = dropout, frames, dtype
        self.fast = _Pathway("fast", fast_w, blocks, FAST_TEMPORAL,
                             (0, 0, 0, 0), dtype, bn_groups)
        self.slow = _Pathway("slow", width, blocks, SLOW_TEMPORAL,
                             [c * FUSION_RATIO for c in fast_out], dtype,
                             bn_groups)
        self.fuse = nn.ModuleDict({STAGE_NAMES[k]: _Fuse(c, dtype, bn_groups)
                                   for k, c in enumerate(fast_out)})
        self.fc = Dense(self.slow.out_channels + self.fast.out_channels,
                        num_classes, dtype)
        self._frames: Dict[Tuple[int, str], torch.Tensor] = {}

    def _slow_frames(self, t: int, device: torch.device) -> torch.Tensor:
        # kept on the device: a pageable copy to the card each step would
        # wait for the card
        key = (t, str(device))
        if key not in self._frames:
            self._frames[key] = slow_frames(t).to(device)
        return self._frames[key]

    def _slow_stem(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = x.index_select(1, self._slow_frames(x.shape[1], x.device))
        return self.slow.stem_out(x, train)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (N, T, H, W, C); ``generator`` draws the head's dropout mask
        in train mode."""
        n, t = x.shape[:2]
        clips = t // self.frames if t > self.frames else 1
        if clips > 1:
            if t % self.frames:
                raise ValueError(f"{t} frames are not whole clips of "
                                 f"{self.frames}")
            x = x.reshape((n * clips, self.frames) + tuple(x.shape[2:]))
        x = x.to(self.dtype)
        slow = spanned("model.slow", self._slow_stem, x, train)
        fast = spanned("model.fast", self.fast.stage, x, 0, train, False)
        for k in range(1, 5):
            slow = spanned("model.fuse", self.fuse[STAGE_NAMES[k - 1]],
                           fast, slow, train)
            slow = spanned("model.slow", self.slow.stage, slow, k, train,
                           k == 4)
            fast = spanned("model.fast", self.fast.stage, fast, k, train,
                           k == 4)
        x = dropout(torch.cat([slow, fast], -1), self.dropout, train,
                    generator)
        logits = self.fc(x).float()
        if clips > 1:
            logits = logits.reshape(n, clips, -1).mean(1)
        return logits

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """PySlowFast's ``init_weights`` (module docstring), drawn from
        ``gen`` on the host."""
        for mod in self.modules():
            if isinstance(mod, Conv3d):
                w = mod.weight
                fan_out = w.shape[0] * math.prod(w.shape[2:])
                w.copy_(torch.randn(w.shape, generator=gen)
                        * math.sqrt(2.0 / fan_out))
            elif isinstance(mod, GroupedBatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            elif isinstance(mod, Dense):
                mod.weight.copy_(0.01 * torch.randn(mod.weight.shape,
                                                    generator=gen))
                mod.bias.zero_()
        for mod in self.modules():
            if isinstance(mod, Bottleneck):
                mod.cb3.bn.weight.zero_()
