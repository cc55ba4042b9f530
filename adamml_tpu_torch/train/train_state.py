"""Training and evaluation state (``adamml_tpu/train/train_state.py``).

Parameters and BN statistics live in the model. The states carry what the
steps read besides them: the Gumbel temperature and the step counter, and
for training both optimizers (each holding its own state).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.adamml import INIT_TEMPERATURE

# Curriculum stages (reference opts.py:77-78, train_adamml.py:334-626).
STAGES = ("warmup", "alternative_training", "finetune")


@dataclasses.dataclass(frozen=True)
class StageFlags:
    """Per-phase flags of the train step.

    warmup / finetune / alternating-main epochs train the main net with the
    policy frozen and zero cost weights (reference train_adamml.py:344-353,
    410-419, 552-564); alternating-policy epochs train the policy with the
    main net frozen and the configured cost weights (train_adamml.py:442-451).
    The policy loss enters the total only while the policy net is training
    (reference utils/utils.py:379-382).
    """

    update_main: bool
    update_policy: bool

    @classmethod
    def main_phase(cls) -> "StageFlags":
        return cls(update_main=True, update_policy=False)

    @classmethod
    def policy_phase(cls) -> "StageFlags":
        return cls(update_main=False, update_policy=True)


@dataclasses.dataclass
class EvalState:
    temperature: float = INIT_TEMPERATURE
    step: int = 0


@dataclasses.dataclass
class TrainState:
    main_opt: torch.optim.Optimizer
    policy_opt: Optional[torch.optim.Optimizer]  # None under rng_policy
    temperature: float = INIT_TEMPERATURE
    step: int = 0
