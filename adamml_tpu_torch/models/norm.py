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
checkpointed forward is recomputed (models/remat.py). The forward and its
backward are one autograd function (ops/kernels/bn_train.py): CUDA kernels
on the card, which keep x in its own dtype for the backward, and their
plain PyTorch versions on the CPU.

``sync`` (set by the model builder for --sync-bn in a process group,
parallel/mesh.py) takes the moments over every data shard's rows: the
local (S, C) mean and mean of squares are averaged over the data group by a
differentiable all-reduce (equal local batches, so that is the global
sum over the global count), and the running update counts the global
rows. At world size 1 the average is x / 1, the same bits as without it.

In train mode the forward runs in the span ``model.bn``
(utils/profiling.py), which, while a CUDA graph is captured or a profiler
runs, also spans its backward: BN's device time in the replayed graph or
an eager trace is labelled.

Parameter and buffer names follow torch (weight, bias, running_mean,
running_var); ckpt/flax_convert.py maps flax's scale/bias/mean/var onto them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import bn_train
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

    def geometry(self, x: torch.Tensor, seq_groups: int = 1,
                 seq_inner: int = 1) -> bn_train.Geom:
        """The moment groups of a train-mode forward of x."""
        n = x.shape[0]
        r, sq, si = max(1, self.groups), max(1, seq_groups), max(1, seq_inner)
        if not (r * sq > 1 and n % (r * sq * si) == 0):
            r = sq = si = 1  # global moments
        return bn_train.geometry(x.shape, r, sq, si)

    def _train(self, x: torch.Tensor, return_affine: bool, seq_groups: int,
               seq_inner: int):
        geom = self.geometry(x, seq_groups, seq_inner)
        count = geom.count
        if self.sync:
            count *= data_world()[0]
        out = bn_train.grouped_bn_train(
            x, self.weight, self.bias,
            (self.running_mean, self.running_var) if self.update_stats
            else None, geom, count / (count - 1) if count > 1 else 1.0,
            MOMENTUM, EPSILON, all_reduce_mean if self.sync else None,
            return_affine)
        return out if return_affine else out.to(self.dtype)
