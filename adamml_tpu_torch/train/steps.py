"""Train and eval steps (``adamml_tpu/train/steps.py``).

The AdaMML train step runs forward, loss, backward, clip, the update of the
live subnet and the metrics. Only the phase's live subnet takes gradients
(``requires_grad_`` per phase, the reference's freezing,
models/adamml.py:114-132); the whole model still runs with ``train=True``,
so the BN statistics of the frozen subnet update too (reference
utils/utils.py:335). Gumbel and dropout noise come from per-step
generators derived from (seed, step), the counterpart of ``_step_rngs``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .losses import compute_policy_loss, cross_entropy
from .optim import clip_by_global_norm, set_lr
from .train_state import EvalState, StageFlags, TrainState


def _topk_metrics(logits: torch.Tensor, targets: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """Mean top-1/top-5 in percent; multi-hot targets count top-1 hits on any
    positive class."""
    if targets.dim() > 1:
        top1 = logits.argmax(dim=-1)
        hit1 = targets.gather(1, top1[:, None])[:, 0] > 0
        return {"top1": 100.0 * hit1.float().mean(),
                "top5": torch.zeros((), device=logits.device)}
    k = min(5, logits.shape[-1])
    # a stable sort ranks tied logits by class index, as lax.top_k does
    # (torch.topk leaves their order open)
    pred = logits.sort(dim=-1, descending=True, stable=True).indices[:, :k]
    correct = pred == targets[:, None]
    return {"top1": 100.0 * correct[:, 0].float().mean(),
            "top5": 100.0 * correct.any(dim=1).float().mean()}


def step_seed(seed: int, step: int) -> int:
    """Per-step generator seed, the counterpart of fold_in(rng, step)."""
    return (seed * 1_000_003 + step) % (2 ** 63)


def step_generators(device: torch.device, seed: int, step: int
                    ) -> Tuple[torch.Generator, torch.Generator]:
    """(gumbel, dropout) generators of one step on ``device``."""
    base = step_seed(seed, step)
    return tuple(torch.Generator(device=device).manual_seed(step_seed(base, k))
                 for k in (0, 1))


def make_adamml_train_step(model: nn.Module, *, flags: StageFlags,
                           penalty_type: str, gammas: float,
                           clip_gradient: Optional[float]) -> Callable:
    """Returns step(state, inputs, target, lr, p_lr, cost_weights, seed) ->
    metrics. The step updates the model's parameters and BN statistics and
    ``state`` (optimizers, step counter) in place. Metrics are tensors on
    the model's device: loss, cls_loss, policy_loss, selection (M,), top1,
    top5."""
    device = next(model.parameters()).device
    has_policy = model.policy_net is not None
    update_policy = flags.update_policy and has_policy
    live = ([model.main_net] if flags.update_main else []) + (
        [model.policy_net] if update_policy else [])

    def step(state: TrainState, inputs: Sequence[torch.Tensor],
             target: torch.Tensor, lr: float, p_lr: float,
             cost_weights: Union[Sequence[float], torch.Tensor], seed: int):
        model.main_net.requires_grad_(flags.update_main)
        if has_policy:
            model.policy_net.requires_grad_(flags.update_policy)
        for opt in (state.main_opt, state.policy_opt):
            if opt is not None:
                opt.zero_grad(set_to_none=True)
        gumbel, drop = step_generators(device, seed, state.step)
        logits, decisions = model(inputs, state.temperature, train=True,
                                  generator=gumbel, dropout_generator=drop)
        cls_loss = cross_entropy(logits, target)
        policy_loss = compute_policy_loss(penalty_type, decisions,
                                          cost_weights, gammas, logits,
                                          target)
        # the policy loss enters the total only while the policy trains
        # (reference utils/utils.py:379-382)
        loss = cls_loss + policy_loss if flags.update_policy else cls_loss
        params = [p for m in live for p in m.parameters()]
        if params:
            loss.backward()
            clip_by_global_norm(params, clip_gradient)
        if flags.update_main:
            set_lr(state.main_opt, lr)
            state.main_opt.step()
        if update_policy:
            set_lr(state.policy_opt, p_lr)
            state.policy_opt.step()
        state.step += 1
        logits = logits.detach()
        return {"loss": loss.detach(), "cls_loss": cls_loss.detach(),
                "policy_loss": policy_loss.detach(),
                "selection": decisions.detach().mean(dim=(0, 1)),
                **_topk_metrics(logits, target)}

    return step


def make_adamml_eval_step(model: nn.Module, num_crops: int = 1) -> Callable:
    """Returns step(state, inputs, target, seed) -> (logits, decisions,
    loss). Gumbel noise is still drawn at eval, as in the reference
    (F.gumbel_softmax samples under model.eval()), from a generator on the
    model's device seeded per step. Runs under torch.no_grad()."""
    if num_crops != 1:
        raise NotImplementedError(
            "num_crops > 1 needs the oversample crop geometry "
            "(adamml_tpu/data/aug_params.py), which waits for the data slice")
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(state: EvalState, inputs, target: torch.Tensor, seed: int):
        gumbel, _ = step_generators(device, seed, state.step)
        logits, decisions = model(inputs, state.temperature, train=False,
                                  generator=gumbel)
        loss = cross_entropy(logits, target)
        return logits, decisions, loss

    return step
