"""Straight-through Gumbel-softmax (``adamml_tpu/ops/gumbel.py``).

Forward emits the hard one-hot of the perturbed argmax; backward uses the
soft softmax gradient. The decision is the LAST column of the 2-way one-hot
(reference models/policy_net.py:283-290). Noise comes from an explicit
``torch.Generator`` on the logits' device; in a data-parallel run it is
drawn for the global batch and each rank keeps its rows
(parallel/mesh.py::local_noise), so it does not depend on the world size.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import local_noise


def sample_gumbel(generator: Optional[torch.Generator],
                  like: torch.Tensor, batch_dim: int = 0) -> torch.Tensor:
    """Standard Gumbel noise shaped like ``like`` (as F.gumbel_softmax),
    whose batch axis is ``batch_dim``."""
    e = local_noise(lambda shape: torch.empty(
        shape, dtype=like.dtype, device=like.device).exponential_(
            generator=generator), like.shape, batch_dim)
    return -e.log()


def perturbed_hard_sample(logits: torch.Tensor, gumbels: torch.Tensor,
                          tau) -> torch.Tensor:
    """Hard ST sample of ``softmax((logits + gumbels) / tau)``; ties go to
    the first index, as argmax does in both frameworks. The forward value is
    exactly the one-hot: ``y_soft - y_soft.detach()`` is 0 before it is
    added (JAX's ``y_hard + y_soft - y_soft`` can land one ulp off 0/1)."""
    y_soft = torch.softmax((logits + gumbels) / tau, dim=-1)
    idx = y_soft.argmax(dim=-1)
    y_hard = F.one_hot(idx, logits.shape[-1]).to(logits.dtype)
    return y_hard + (y_soft - y_soft.detach())


def gumbel_softmax_hard(generator: Optional[torch.Generator],
                        logits: torch.Tensor, tau,
                        batch_dim: int = 0) -> torch.Tensor:
    """Hard ST Gumbel-softmax sample, shape = logits (..., K)."""
    return perturbed_hard_sample(
        logits, sample_gumbel(generator, logits, batch_dim), tau)


def gumbel_decision(generator: Optional[torch.Generator],
                    logits: torch.Tensor, tau) -> torch.Tensor:
    """ON/OFF decision = last column of the hard 2-way sample of the
    policy's (M, N, 2) logits (batch axis 1)."""
    return gumbel_softmax_hard(generator, logits, tau, batch_dim=1)[..., -1]
