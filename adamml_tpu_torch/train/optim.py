"""The two optimizers (``adamml_tpu/train/optim.py``).

The main net trains with SGD: L2 weight decay added to the gradient,
heavy-ball momentum with dampening 0, optional nesterov. The policy net
trains with torch Adam (L2 in the gradient, not AdamW), b1 0.9, b2 0.999,
eps 1e-8, bias-corrected. Both are torch's per-tensor optimizers with
``foreach=True``, which compute the JAX package's update; its FusedSGD
ravels the parameters into one vector only to cut TPU dispatches, which
``foreach`` does here. The step sets each optimizer's learning rate per call.
Frozen parameters carry no gradient (None, not zero), so neither optimizer
decays or moves them.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def build_optimizer(kind: str, cfg_optim,
                    params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """'main': SGD (reference train_adamml.py:254-257); 'policy': Adam
    (reference train_adamml.py:251). The learning rate is set per step."""
    if kind == "main":
        return torch.optim.SGD(params, lr=cfg_optim.lr,
                               momentum=cfg_optim.momentum,
                               nesterov=cfg_optim.nesterov,
                               weight_decay=cfg_optim.weight_decay,
                               foreach=True)
    if kind == "policy":
        return torch.optim.Adam(params, lr=cfg_optim.p_lr, betas=ADAM_BETAS,
                                eps=ADAM_EPS,
                                weight_decay=cfg_optim.weight_decay,
                                foreach=True)
    raise ValueError(kind)


def clip_by_global_norm(params: Iterable[torch.nn.Parameter],
                        max_norm: Optional[float]) -> None:
    """Whole-model global-norm clip of the gradients present (reference
    utils/utils.py:392-393): scale = min(1, max_norm / (norm + 1e-6)), the
    formula of ``clip_grad_norm_``."""
    if max_norm is not None:
        torch.nn.utils.clip_grad_norm_(params, max_norm, foreach=True)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
