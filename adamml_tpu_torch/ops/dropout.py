"""Dropout and drop path with an explicit generator (flax ``nn.Dropout``).

Keeps each element with probability 1 - p, drawn as ``rand < 1 - p`` from
the caller's ``torch.Generator`` on the tensor's device, and scales what it
keeps by 1/(1 - p). The global generator is never read, so a step seeded
from (seed, step) repeats exactly. The rows (axis 0) are the batch's: in a
data-parallel run the mask is drawn for the global batch and each rank
keeps its rows (parallel/mesh.py::local_noise).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import local_noise


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if not train or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("train-mode dropout needs a generator")
    keep_prob = 1.0 - p
    keep = local_noise(lambda shape: torch.rand(
        shape, generator=generator, device=x.device), x.shape) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def drop_path(x: torch.Tensor, p: float, train: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth: a residual branch's output x (N, ...) is kept
    whole for a row with probability 1 - p, drawn as ``rand(N) < 1 - p``,
    and scaled by 1/(1 - p); a rate of 0 draws nothing."""
    if not train or p == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode drop path needs a generator")
    keep_prob = 1.0 - p
    keep = local_noise(lambda shape: torch.rand(
        shape, generator=generator, device=x.device), x.shape[:1]) < keep_prob
    keep = keep.view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
