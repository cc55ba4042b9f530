"""Losses (``adamml_tpu/train/losses.py``): classification CE and the
selection-penalty ("policy") loss.

``compute_policy_loss`` keeps the reference's quirks (reference
utils/utils.py:166-184): the blockdrop variant squares the per-video mean
selection, gates it on the detached top-1 correctness, and adds a
``gammas * (1 - correct)`` term that is constant w.r.t. the parameters (it
shifts the logged loss but gives no gradient).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE. Integer targets (N,) or soft/multi-hot targets (N, K)."""
    if targets.dim() == 1:
        return F.cross_entropy(logits, targets.long())
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def compute_policy_loss(penalty_type: str, selection: torch.Tensor,
                        cost_weights: Union[Sequence[float], torch.Tensor],
                        gammas: float, cls_logits: torch.Tensor,
                        cls_targets: torch.Tensor) -> torch.Tensor:
    """selection: (N, S, M) 0/1 decisions (straight-through grads attached).

    'mean': sum_m w_m * mean(selection_m)
    'blockdrop': correctness-gated squared per-video selection rate plus the
    constant gammas term
    """
    num_modality = selection.shape[-1]
    w = torch.as_tensor(cost_weights, dtype=selection.dtype,
                        device=selection.device)
    if penalty_type == "mean":
        return (w * selection.mean(dim=(0, 1))).sum()
    if penalty_type != "blockdrop":
        raise ValueError(f"unknown penalty_type {penalty_type!r}")

    top1 = cls_logits.detach().argmax(dim=-1)
    if cls_targets.dim() > 1:  # multi-hot -> any positive class counts
        correct = cls_targets.gather(1, top1[:, None])[:, 0] > 0
    else:
        correct = top1 == cls_targets
    correct = correct.to(cls_logits.dtype)

    sel = selection.mean(dim=1)                           # (N, M) per video
    sel = sel * sel                                       # squared
    gated = (correct[:, None] * sel).mean(dim=0)          # (M,)
    loss = (w[:num_modality] * gated).sum()
    return loss + ((1.0 - correct) * gammas).mean()
