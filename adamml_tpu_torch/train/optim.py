"""The two optimizers (``adamml_tpu/train/optim.py``).

The main net trains with SGD: L2 weight decay added to the gradient,
heavy-ball momentum with dampening 0, optional nesterov. The policy net
trains with Adam (L2 in the gradient, not AdamW), b1 0.9, b2 0.999, eps
1e-8, bias-corrected. ``--optimizer adamw`` trains train_unimodal's
backbone with AdamW instead (the port's own flag; PySlowFast's MViTv2
recipe): the same Adam with decoupled decay, p <- p (1 - lr wd) before the
update, and no decay on 1-D parameters (biases, norms; PySlowFast's
``ZERO_WD_1D_PARAM``) in a second param group. All keep torch's classes,
state dicts and ``foreach`` switch (``fused_update=False``,
``--no_fused_update``, gives ``foreach=False``: one update per tensor, the
same math and the same state dict); the JAX package's FusedSGD ravels the parameters into one vector
only to cut TPU dispatches, which ``foreach`` does here.

Their ``step`` is the port's own, written with ``_foreach`` ops so that it
reads the learning rate from a device tensor and makes no host read: the
same update runs in single steps, inside a captured CUDA graph
(``steps.make_adamml_multi_step``) and on the CPU. torch's own SGD turns a
tensor learning rate into a host scalar. torch's Adam can be captured only
with ``capturable=True``, and then refuses parameters on the CPU (torch
2.13: "If capturable=True, params and state_steps must be on supported
devices"), so the CPU tests would hold a different update from the card's;
without it, its step count is read on the host. Here Adam's step count is a
float32 tensor on the parameters' device (the layout of torch's capturable
Adam) and the bias corrections are taken on the device.
``set_lr`` writes the learning rate into that tensor (and into the
group's ``lr`` entry, which the state dict saves). Frozen parameters carry
no gradient (None, not zero), so neither optimizer decays or moves them.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import param_shard

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _group_lr(opt: torch.optim.Optimizer, gi: int,
              device: torch.device) -> torch.Tensor:
    """The device tensor of param group ``gi``'s learning rate, made from
    the group's ``lr`` the first time (outside any capture: ``set_lr``
    runs before every step)."""
    lrs = opt.__dict__.setdefault("_lr_tensors", {})
    t = lrs.get(gi)
    if t is None or t.device != device:
        t = torch.full((), float(opt.param_groups[gi]["lr"]),
                       dtype=torch.float32, device=device)
        lrs[gi] = t
    return t


def _live(group) -> List[torch.Tensor]:
    return [p for p in group["params"] if p.grad is not None]


class SGD(torch.optim.SGD):
    """torch's SGD (same defaults and state dict: ``momentum_buffer``), its
    step written on a device learning rate."""

    @torch.no_grad()
    def step(self, closure=None):
        for gi, group in enumerate(self.param_groups):
            params = _live(group)
            if not params:
                continue
            lr = _group_lr(self, gi, params[0].device)
            grads = [p.grad for p in params]
            wd, mom = group["weight_decay"], group["momentum"]
            damp, nesterov = group["dampening"], group["nesterov"]
            if group["foreach"]:
                if wd != 0:
                    grads = torch._foreach_add(grads, params, alpha=wd)
                if mom != 0:
                    bufs = [self.state[p].get("momentum_buffer")
                            for p in params]
                    if any(b is None for b in bufs):
                        # the first step: the buffer is the gradient
                        for i, p in enumerate(params):
                            if bufs[i] is None:
                                bufs[i] = grads[i].detach().clone()
                                self.state[p]["momentum_buffer"] = bufs[i]
                            else:
                                bufs[i].mul_(mom).add_(grads[i],
                                                       alpha=1 - damp)
                    else:
                        torch._foreach_mul_(bufs, mom)
                        torch._foreach_add_(bufs, grads, alpha=1 - damp)
                    grads = (torch._foreach_add(grads, bufs, alpha=mom)
                             if nesterov else bufs)
                torch._foreach_sub_(params, torch._foreach_mul(grads, lr))
                continue
            for p in params:
                g = p.grad
                if wd != 0:
                    g = g.add(p, alpha=wd)
                if mom != 0:
                    buf = self.state[p].get("momentum_buffer")
                    if buf is None:
                        buf = g.detach().clone()
                        self.state[p]["momentum_buffer"] = buf
                    else:
                        buf.mul_(mom).add_(g, alpha=1 - damp)
                    g = g.add(buf, alpha=mom) if nesterov else buf
                p.sub_(g * lr)
        return None


class Adam(torch.optim.Adam):
    """torch's Adam with L2 in the gradient (same defaults and state dict:
    ``step``, ``exp_avg``, ``exp_avg_sq``; ``capturable=True``, so a loaded
    ``step`` lands on the parameters' device), its step written on a
    device learning rate and a device step count; with
    ``decoupled_weight_decay`` (``AdamW``) the decay scales the parameters
    before the update instead."""

    def __init__(self, params, **kwargs):
        super().__init__(params, capturable=True, **kwargs)

    @torch.no_grad()
    def step(self, closure=None):
        for gi, group in enumerate(self.param_groups):
            params = _live(group)
            if not params:
                continue
            dev = params[0].device
            lr = _group_lr(self, gi, dev)
            b1, b2 = group["betas"]
            wd, eps = group["weight_decay"], group["eps"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32,
                                             device=dev)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            steps = [self.state[p]["step"] for p in params]
            m = [self.state[p]["exp_avg"] for p in params]
            v = [self.state[p]["exp_avg_sq"] for p in params]
            grads = [p.grad for p in params]
            torch._foreach_add_(steps, 1.0)
            # per parameter, from its own count: 1 - b1^t, sqrt(1 - b2^t)
            bc1 = torch._foreach_pow(b1, steps)
            torch._foreach_neg_(bc1)
            torch._foreach_add_(bc1, 1.0)
            bc2 = torch._foreach_pow(b2, steps)
            torch._foreach_neg_(bc2)
            torch._foreach_add_(bc2, 1.0)
            torch._foreach_sqrt_(bc2)
            decoupled = group.get("decoupled_weight_decay", False)
            if decoupled and wd != 0:
                torch._foreach_mul_(params, 1.0 - lr * wd)
            if group["foreach"]:
                if wd != 0 and not decoupled:
                    grads = torch._foreach_add(grads, params, alpha=wd)
                torch._foreach_lerp_(m, grads, 1.0 - b1)
                torch._foreach_mul_(v, b2)
                torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
                denom = torch._foreach_sqrt(v)
                torch._foreach_div_(denom, bc2)
                torch._foreach_add_(denom, eps)
                upd = torch._foreach_div(m, denom)
                torch._foreach_div_(upd, bc1)
                torch._foreach_mul_(upd, lr)
                torch._foreach_sub_(params, upd)
                continue
            for p, g, mi, vi, c1, c2 in zip(params, grads, m, v, bc1, bc2):
                if wd != 0 and not decoupled:
                    g = g.add(p, alpha=wd)
                mi.lerp_(g, 1.0 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (vi.sqrt() / c2).add_(eps)
                p.sub_((mi / denom) / c1 * lr)
        return None


class AdamW(Adam):
    """``Adam`` with decoupled weight decay (torch's AdamW update)."""

    def __init__(self, params, **kwargs):
        super().__init__(params, decoupled_weight_decay=True, **kwargs)


def build_optimizer(kind: str, cfg_optim,
                    params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """'main': SGD (reference train_adamml.py:254-257), or AdamW under
    ``--optimizer adamw`` (1-D parameters in a group of their own without
    decay); 'policy': Adam (reference train_adamml.py:251). The learning
    rate is set per step."""
    if kind == "main" and cfg_optim.optimizer == "adamw":
        params = list(params)
        groups = [{"params": [p for p in params if p.dim() > 1]},
                  {"params": [p for p in params if p.dim() <= 1],
                   "weight_decay": 0.0}]
        return AdamW([g for g in groups if g["params"]], lr=cfg_optim.lr,
                     betas=ADAM_BETAS, eps=ADAM_EPS,
                     weight_decay=cfg_optim.weight_decay,
                     foreach=cfg_optim.fused_update)
    if kind == "main":
        return SGD(params, lr=cfg_optim.lr, momentum=cfg_optim.momentum,
                   nesterov=cfg_optim.nesterov,
                   weight_decay=cfg_optim.weight_decay,
                   foreach=cfg_optim.fused_update)
    if kind == "policy":
        return Adam(params, lr=cfg_optim.p_lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                    weight_decay=cfg_optim.weight_decay,
                    foreach=cfg_optim.fused_update)
    raise ValueError(kind)


def clip_by_global_norm(params: Iterable[torch.nn.Parameter],
                        max_norm: Optional[float]
                        ) -> Optional[torch.Tensor]:
    """Whole-model global-norm clip of the gradients present (reference
    utils/utils.py:392-393): scale = min(1, max_norm / (norm + 1e-6)), the
    formula of ``clip_grad_norm_``, which reads nothing back to the host.
    Returns the norm (None when ``max_norm`` is None). With tensor-parallel
    shards the norm counts each replicated gradient once and sums each
    sharded gradient's squares over the model group, so every rank takes
    the single process's norm and scale."""
    if max_norm is None:
        return None
    params = [p for p in params if p.grad is not None]
    shards = [param_shard(p) for p in params]
    if all(sh is None for sh in shards):
        return torch.nn.utils.clip_grad_norm_(params, max_norm, foreach=True)
    grads = [p.grad for p in params]
    norms = torch._foreach_norm(grads)
    rep = [n for n, sh in zip(norms, shards) if sh is None]
    sharded = torch.stack([n for n, sh in zip(norms, shards)
                           if sh is not None]).float().square().sum()
    dist.all_reduce(sharded, group=next(sh for sh in shards
                                        if sh is not None).group)
    norm = (sharded + torch.stack(rep).float().square().sum()
            if rep else sharded).sqrt()
    coef = (max_norm / (norm + 1e-6)).clamp(max=1.0)
    torch._foreach_mul_(grads, coef)
    return norm


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of every group, into its device tensor (an
    asynchronous fill; outside a captured graph, which reads the tensor)
    and its ``lr`` entry."""
    for gi, group in enumerate(opt.param_groups):
        group["lr"] = lr
        params = group["params"]
        if params:
            _group_lr(opt, gi, params[0].device).fill_(lr)
