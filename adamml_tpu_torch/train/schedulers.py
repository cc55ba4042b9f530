"""Learning-rate schedules (the port's copy of
``adamml_tpu/train/schedulers.py``).

Closed-form epoch -> lr functions for step / multisteps / cosine (the
reference calls torch schedulers with explicit epoch arguments, reference
train_adamml.py:259-270,460-465, so closed forms are exact), plus a stateful
ReduceLROnPlateau twin with torch defaults.
"""

from __future__ import annotations

import bisect
import math
from typing import Sequence


def lr_at_epoch(scheduler: str, base_lr: float, epoch: int,
                lr_steps: Sequence[float], total_epochs: int) -> float:
    """lr for the given (0-based) epoch index."""
    if scheduler == "step":
        # torch StepLR(step_size=lr_steps[0], gamma=0.1)
        return base_lr * (0.1 ** (epoch // int(lr_steps[0])))
    if scheduler == "multisteps":
        # torch MultiStepLR(milestones=lr_steps, gamma=0.1)
        return base_lr * (0.1 ** bisect.bisect_right(sorted(lr_steps), epoch))
    if scheduler == "cosine":
        # torch CosineAnnealingLR(T_max=total_epochs, eta_min=0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / total_epochs))
    if scheduler == "plateau":
        raise ValueError("plateau is stateful; use ReduceLROnPlateau")
    raise ValueError(f"unknown scheduler {scheduler!r}")


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau defaults: mode='min',
    factor=0.1, patience=10, threshold=1e-4 (rel)."""

    def __init__(self, base_lr: float, factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4) -> None:
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = math.inf
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad = state["num_bad"]
