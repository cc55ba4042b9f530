"""MViTv2-S 16x4 (Li, Wu, Fan, Mangalam, Xiong, Malik, Feichtenhofer,
"MViTv2: Improved Multiscale Vision Transformers for Classification and
Detection", CVPR 2022, arXiv:2112.01526; PySlowFast's
``configs/Kinetics/MVITv2_S_16x4.yaml``), the port's video transformer,
over channels-last clips.

Input (N, T, H, W, 3): one clip of T frames (train_unimodal's unimodal
preprocessor folds the loader's (N, 1, T, ...) segment into time); with T
a multiple k > 1 of ``frames`` the rows hold k clips each (multi-clip
eval), whose logits are averaged.

- Patch embedding: conv [3, 7, 7], stride (2, 4, 4), padding (1, 3, 3),
  with bias, to ``embed_dim`` (96) channels: a (8, 56, 56) grid of tokens
  at 16 frames of 224 px, in (T, H, W) order, and the cls token before
  them. No absolute position embedding.
- ``depth`` (16) ``MultiScaleBlock``s. At each block of ``transitions``
  (1, 3, 14) the width and the heads double (96 -> 192 -> 384 -> 768, 1 ->
  8 heads of 96) inside the attention, Q is pooled with stride (1, 2, 2),
  and the skip is Linear(LN1(x)) then a max-pool [1, 3, 3], stride
  (1, 2, 2), padding (0, 1, 1) of the non-cls tokens; K and V are pooled
  with the adaptive stride, ``kv_stride`` (8) divided by each Q stride so
  far, so K and V hold 8 x 7 x 7 tokens, or 8 x 14 x 14 at a transition
  (its input grid over the halved stride).
- Attention: qkv = Linear(C_in, 3 C_out); Q, K and V each through a
  depthwise conv [3, 3, 3] shared by the heads over the non-cls tokens
  (channels first: ``Conv3d.ncdhw``) and a LayerNorm over every token
  (``model.pool``); the logits with the
  decomposed relative positions, the softmax, @ v and residual pooling
  (``ops/attention.py``, ``model.attn``); the output projection.
- MLP (``model.mlp``): LN2, Linear 4x, GELU (exact), Linear.
- Drop path over the two residual branches, rates linspace(0, 0.2, 16),
  drawn from the step's generator in block order, attention then MLP.
- Head: LayerNorm, the cls token, dropout, Linear. Eval mode returns the
  logits. Every LayerNorm has eps 1e-6.

Every Linear, LayerNorm and conv computes in ``dtype`` over float32
parameters. ``init_weights`` is PySlowFast's: Linear weights and the cls
token and relative-position tables truncated normal with std 0.02 (cut
at +-2), biases 0, LayerNorms 1 and 0, convs torch's default.

Spans (utils/profiling.py), forward and backward, none inside another:
``model.pool`` (a block's three pooling convs with their LayerNorms, the
cls split and join), ``model.attn`` (the logits, the relative positions,
the softmax, @ v, residual pooling), ``model.mlp``. The qkv and output
projections and the skip lie outside them.

Parameter names are PySlowFast's but for ``patch_embed`` and ``head``
(its ``patch_embed.proj`` and ``head.projection``): ``cls_token``,
``blocks.{i}.{norm1,norm2,proj}``, ``blocks.{i}.attn.{qkv,proj,pool_q,
pool_k,pool_v,norm_q,norm_k,norm_v,rel_pos_h,rel_pos_w,rel_pos_t}``,
``blocks.{i}.mlp.{fc1,fc2}``, ``norm``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import pooled_attention, rel_dist, rel_pos_bias
from ..ops.dropout import drop_path, dropout
from ..utils.profiling import spanned
from .layers import Conv3d, Dense, LayerNorm

PATCH_KERNEL = (3, 7, 7)
PATCH_STRIDE = (2, 4, 4)
MLP_RATIO = 4

Grid = Tuple[int, int, int]


def _pooled(grid: Grid, stride: int) -> Grid:
    """A grid after a [3, 3, 3] conv, padding 1, spatial stride."""
    t, h, w = grid
    return t, (h - 1) // stride + 1, (w - 1) // stride + 1


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, grid: Grid,
                 stride_q: int, stride_kv: int, frames: int, dtype):
        super().__init__()
        d = dim_out // heads
        self.heads, self.head_dim, self.dim_out = heads, d, dim_out
        self.grid, self.scale = grid, d ** -0.5
        self.q_grid, self.kv_grid = _pooled(grid, stride_q), \
            _pooled(grid, stride_kv)
        self.qkv = Dense(dim, 3 * dim_out, dtype)
        self.proj = Dense(dim_out, dim_out, dtype)
        for w, s in (("q", stride_q), ("k", stride_kv), ("v", stride_kv)):
            setattr(self, f"pool_{w}", Conv3d(d, d, (3, 3, 3),
                                              (1, s, s), dtype, groups=d))
            setattr(self, f"norm_{w}", LayerNorm(d, dtype))
        sp = 2 * max(self.q_grid[1], self.kv_grid[1]) - 1
        self.rel_pos_h = nn.Parameter(torch.zeros(sp, d))
        self.rel_pos_w = nn.Parameter(torch.zeros(sp, d))
        self.rel_pos_t = nn.Parameter(torch.zeros(2 * frames - 1, d))
        for axis in range(3):
            self.register_buffer(f"dist_{'thw'[axis]}", rel_dist(
                self.q_grid[axis], self.kv_grid[axis]), persistent=False)

    def _pool(self, qkv: torch.Tensor):
        """qkv (N, L, 3, heads, d) -> pooled q, k, v (N, heads, L', d); the
        convolutions take their input channels first (``Conv3d.ncdhw``)."""
        n, h, d = qkv.shape[0], self.heads, self.head_dim
        out = []
        for j, w in enumerate("qkv"):
            t = qkv[:, :, j].transpose(1, 2)
            sp = t[:, :, 1:].transpose(2, 3).reshape((n * h, d) + self.grid)
            sp = getattr(self, f"pool_{w}").ncdhw(sp)
            sp = sp.reshape(n, h, d, -1).transpose(2, 3)
            out.append(getattr(self, f"norm_{w}")(
                torch.cat([t[:, :, :1], sp], 2)))
        return tuple(out)

    def _attend(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        bias = rel_pos_bias(q[:, :, 1:],
                            (self.rel_pos_t, self.rel_pos_h, self.rel_pos_w),
                            (self.dist_t, self.dist_h, self.dist_w),
                            self.q_grid, self.kv_grid)
        return pooled_attention(q, k, v, bias, self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, length, _ = x.shape
        qkv = self.qkv(x).view(n, length, 3, self.heads, self.head_dim)
        q, k, v = spanned("model.pool", self._pool, qkv)
        out = spanned("model.attn", self._attend, q, k, v)
        return self.proj(out.transpose(1, 2).reshape(n, -1, self.dim_out))


class Mlp(nn.Module):
    def __init__(self, dim: int, dtype):
        super().__init__()
        self.fc1 = Dense(dim, MLP_RATIO * dim, dtype)
        self.fc2 = Dense(MLP_RATIO * dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, grid: Grid,
                 stride_q: int, stride_kv: int, frames: int, drop: float,
                 dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = MultiScaleAttention(dim, dim_out, heads, grid, stride_q,
                                        stride_kv, frames, dtype)
        self.norm2 = LayerNorm(dim_out, dtype)
        self.mlp = Mlp(dim_out, dtype)
        self.proj = Dense(dim, dim_out, dtype) if dim != dim_out else None
        self.grid, self.stride_q, self.drop = grid, stride_q, drop

    def _skip(self, x: torch.Tensor) -> torch.Tensor:
        """Max-pool [1, 3, 3], stride (1, 2, 2), padding (0, 1, 1) of the
        non-cls tokens; the cls token passes."""
        sp = x[:, 1:].reshape((x.shape[0],) + self.grid + (x.shape[-1],))
        sp = F.max_pool3d(sp.permute(0, 4, 1, 2, 3), (1, 3, 3), (1, 2, 2),
                          (0, 1, 1))
        return torch.cat([x[:, :1], sp.flatten(2).transpose(1, 2)], 1)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.norm2(x))

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        xn = self.norm1(x)
        att = self.attn(xn)
        skip = x if self.proj is None else self.proj(xn)
        if self.stride_q > 1:
            skip = self._skip(skip)
        x = skip + drop_path(att, self.drop, train, generator)
        return x + drop_path(spanned("model.mlp", self._mlp, x), self.drop,
                             train, generator)


class MViT(nn.Module):
    """MViTv2 over (N, T, H, W, 3) clips; ``forward`` returns float32
    logits (N, K). The defaults are MViTv2-S 16x4; the CPU tests build
    smaller ones through ``embed_dim``, ``depth``, ``transitions``,
    ``kv_stride``, ``frames`` and ``input_size``."""

    def __init__(self, num_classes: int = 400, dropout: float = 0.5,
                 embed_dim: int = 96, num_heads: int = 1, depth: int = 16,
                 transitions: Sequence[int] = (1, 3, 14), kv_stride: int = 8,
                 frames: int = 16, input_size: int = 224,
                 drop_path: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.frames, self.dtype = dropout, frames, dtype
        self.patch_embed = Conv3d(3, embed_dim, PATCH_KERNEL, PATCH_STRIDE,
                                  dtype, bias=True)
        t = (frames - 1) // PATCH_STRIDE[0] + 1
        s = (input_size - 1) // PATCH_STRIDE[1] + 1
        self.input_size = input_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        rates = torch.linspace(0, drop_path, depth, device="cpu").tolist()
        dim, heads, kv, grid = embed_dim, num_heads, kv_stride, (t, s, s)
        self.blocks = nn.ModuleList()
        for i in range(depth):
            sq = 2 if i in transitions else 1
            dim_out, heads = (2 * dim, 2 * heads) if sq == 2 else (dim, heads)
            kv = max(kv // sq, 1)
            self.blocks.append(MultiScaleBlock(dim, dim_out, heads, grid, sq,
                                               kv, t, rates[i], dtype))
            dim, grid = dim_out, _pooled(grid, sq)
        self.norm = LayerNorm(dim, dtype)
        self.head = Dense(dim, num_classes, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (N, T, H, W, 3); ``generator`` draws the drop-path masks and
        the head's dropout mask in train mode."""
        n, t = x.shape[:2]
        clips = t // self.frames if t > self.frames else 1
        if clips > 1:
            if t % self.frames:
                raise ValueError(f"{t} frames are not whole clips of "
                                 f"{self.frames}")
            x = x.reshape((n * clips, self.frames) + tuple(x.shape[2:]))
        if tuple(x.shape[1:4]) != (self.frames, self.input_size,
                                   self.input_size):
            raise ValueError(f"MViT is built for clips of {self.frames} x "
                             f"{self.input_size} x {self.input_size}, not "
                             f"{tuple(x.shape[1:4])}")
        x = self.patch_embed(x.to(self.dtype))
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        x = torch.cat([self.cls_token.to(self.dtype).expand(x.shape[0], -1,
                                                            -1), x], 1)
        for blk in self.blocks:
            x = blk(x, train, generator)
        x = dropout(self.norm(x)[:, 0], self.dropout, train, generator)
        logits = self.head(x).float()
        if clips > 1:
            logits = logits.reshape(n, clips, -1).mean(1)
        return logits

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """PySlowFast's init (module docstring), drawn from ``gen`` on the
        host."""
        for mod in self.modules():
            if isinstance(mod, Dense):
                nn.init.trunc_normal_(mod.weight, std=0.02, generator=gen)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, Conv3d):
                w = mod.weight
                nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=gen)
                if mod.bias is not None:
                    bound = 1.0 / math.sqrt(math.prod(w.shape[1:]))
                    nn.init.uniform_(mod.bias, -bound, bound, generator=gen)
            elif isinstance(mod, MultiScaleAttention):
                for tab in (mod.rel_pos_h, mod.rel_pos_w, mod.rel_pos_t):
                    nn.init.trunc_normal_(tab, std=0.02, generator=gen)
        nn.init.trunc_normal_(self.cls_token, std=0.02, generator=gen)
