"""Rematerialization (flax ``nn.remat``) for the port's modules.

``remat(module, fn, *args)`` runs ``fn(*args)`` under
``torch.utils.checkpoint`` (non-reentrant): its activations are not kept,
and the backward runs the forward again to rebuild them. flax's remat is
functional, so a recomputed BatchNorm cannot update its statistics twice;
here the running statistics are buffers updated in place, so every
GroupedBatchNorm inside ``module`` skips its update while the forward is
recomputed. The regions this wraps draw no random numbers, so the global
generator's state is not saved. The recomputed forward runs in the span
``model.remat`` (utils/profiling.py): in a captured graph its kernels are
not put down to a span of the backward that asked for it, and its BNs
count under their own spans.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import span
from .norm import GroupedBatchNorm


def remat(module: nn.Module, fn: Callable, *args):
    first = True

    def run(*a):
        nonlocal first
        if first:
            first = False
            return fn(*a)
        bns = [m for m in module.modules()
               if isinstance(m, GroupedBatchNorm)]
        for bn in bns:
            bn.update_stats = False
        try:
            with span("model.remat"):
                return fn(*a)
        finally:
            for bn in bns:
                bn.update_stats = True

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def remat_active(enabled: bool, train: bool) -> bool:
    """Remat only where a backward will run."""
    return enabled and train and torch.is_grad_enabled()
