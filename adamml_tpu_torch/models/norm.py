"""Batch normalization with grouped moments (``adamml_tpu/models/norm.py``).

Normalizes over the last (channel) axis as the affine x * a + b with
a = scale * rsqrt(var + eps), b = bias - mean * a, in float32, and casts back
to the compute dtype. ``return_affine=True`` returns (a, b) instead of
applying them, so a consumer can fuse the normalize into its own kernel
(ops/kernels/tpool_fused.py): (1, 1, C) from the running statistics in
eval, (R, S, C) from the batch moments in train.

Train mode: the leading axis is (clips, segments, frames)-ordered, so it
factors freely into (R replica groups, clips per group, S segments,
``seq_inner`` frames). Moments ``var = E[x^2] - mean^2`` are taken in
float32 per (replica, segment) over (clips, frames, spatial); a batch that
does not split so (or R = S = 1) takes global moments. The running
statistics see replica group 0's moments only, with the unbiased variance
(count / (count - 1)), folded over the S segments in order as S
consecutive BN forwards would: ra <- m^S ra + sum_i (1-m) m^(S-1-i) moment_i,
m = 0.9. They move once per forward: ``update_stats`` is False while a
checkpointed forward is recomputed (models/remat.py).

``sync`` (set by the model builder for --sync-bn in a process group,
parallel/mesh.py) takes the moments over every data shard's rows: the
local (S, C) mean and mean of squares are averaged over the data group by a
differentiable all-reduce (equal local batches, so that is the global
sum over the global count), and the running update counts the global
rows. At world size 1 the average is x / 1, the same bits as without it.

In train mode the forward runs in the span ``model.bn``
(utils/profiling.py), which, while a CUDA graph is captured, also spans
its backward: BN's device time in the replayed graph is labelled.

Parameter and buffer names follow torch (weight, bias, running_mean,
running_var); ckpt/flax_convert.py maps flax's scale/bias/mean/var onto them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import all_reduce_mean, data_world
from ..utils.profiling import spanned

EPSILON = 1e-5  # every BN of the JAX models (adamml_tpu/models/norm.py:39)
MOMENTUM = 0.9  # adamml_tpu/models/norm.py:38


class GroupedBatchNorm(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dtype = dtype
        self.groups = groups
        self.sync = False
        self.update_stats = True

    def forward(self, x: torch.Tensor, train: bool = False,
                return_affine: bool = False, seq_groups: int = 1,
                seq_inner: int = 1):
        if not train:
            a = self.weight * torch.rsqrt(self.running_var + EPSILON)
            b = self.bias - self.running_mean * a
            if return_affine:
                return a[None, None], b[None, None]
            # one float32 pass (x promotes to a's dtype inside the op) and one
            # cast, where (x - mean) * rsqrt(var + eps) * scale + bias would
            # take five float32 passes over the activation in eager mode
            return torch.addcmul(b, x, a).to(self.dtype)
        return spanned("model.bn", self._train, x, return_affine,
                       seq_groups, seq_inner)

    def _train(self, x: torch.Tensor, return_affine: bool, seq_groups: int,
               seq_inner: int):
        n, c = x.shape[0], x.shape[-1]
        r, sq, si = max(1, self.groups), max(1, seq_groups), max(1, seq_inner)
        if not (r * sq > 1 and n % (r * sq * si) == 0):
            r = sq = si = 1  # global moments
        gshape = (r, n // (r * sq * si), sq, si) + tuple(x.shape[1:])
        red = (1, 3) + tuple(range(4, len(gshape) - 1))
        xf = x.float().reshape(gshape)
        mean = xf.mean(red)                                  # (R, S, C)
        meansq = (xf * xf).mean(red)
        count = x.numel() // (r * sq * c)
        if self.sync:
            mean, meansq = all_reduce_mean(torch.stack([mean, meansq]))
            count *= data_world()[0]
        var = meansq - mean * mean
        if self.update_stats:
            self._update_running(mean[0], var[0], count)
        a = self.weight * torch.rsqrt(var + EPSILON)
        b = self.bias - mean * a
        if return_affine:
            return a, b
        bshape = (r, 1, sq, 1) + (1,) * (len(gshape) - 5) + (c,)
        y = torch.addcmul(b.reshape(bshape), x.reshape(gshape),
                          a.reshape(bshape))
        return y.reshape(x.shape).to(self.dtype)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor,
                        count: int) -> None:
        """Fold the (S, C) moment sets into the running statistics."""
        m, s = MOMENTUM, mean.shape[0]
        if count > 1:
            var = var * (count / (count - 1))
        w = (1.0 - m) * torch.pow(m, torch.arange(
            s - 1, -1, -1, dtype=torch.float32, device=mean.device))
        self.running_mean.mul_(m ** s).add_(w @ mean)
        self.running_var.mul_(m ** s).add_(w @ var)
