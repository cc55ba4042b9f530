"""Policy (decision) network (``adamml_tpu/models/policy_net.py``).

Per-modality MobileNetV2 trunks -> concat -> 2-layer MLP(2048) ->
LSTMCell(2048 + 2M -> 256) -> per-modality Linear(256 -> 2) ->
straight-through Gumbel decision (reference models/policy_net.py:206-379).
All N*S segment feature extractions run as one batch (train-mode BN moments
per segment); the recurrence is a Python loop over the S segments. Gumbel
noise comes from one ``torch.Generator``, drawn segment by segment. With
``remat_trunk`` the trunks' activations are recomputed in the backward
(models/remat.py), so they do not sit on top of the main net's.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.gumbel import gumbel_decision
from .layers import Dense
from .mobilenet_v2 import MobileNetV2
from .remat import remat, remat_active

JOINT_DIM = 2048     # reference models/policy_net.py:227
LSTM_HIDDEN = 256    # reference models/policy_net.py:277


class _DecisionCell(nn.Module):
    """One LSTM step + decision heads (reference models/policy_net.py:341-365).

    carry: (h, c, prev_logits_flat); feat: joint features (N, JOINT_DIM). The
    recurrent input appends the previous segment's raw logits (zeros at
    t=0), flattened sample-major as (N, 2M). Gates in torch LSTMCell order
    i, f, g, o."""

    def __init__(self, num_modality: int, dtype: torch.dtype):
        super().__init__()
        self.num_modality = num_modality
        self.dtype = dtype
        self.ih = Dense(JOINT_DIM + 2 * num_modality, 4 * LSTM_HIDDEN, dtype)
        self.hh = Dense(LSTM_HIDDEN, 4 * LSTM_HIDDEN, dtype)
        for m in range(num_modality):
            self.add_module(f"fc_{m}", Dense(LSTM_HIDDEN, 2, dtype))

    def forward(self, carry, feat, tau, generator):
        h, c, prev_logits = carry
        lstm_in = torch.cat([feat.to(self.dtype), prev_logits.to(self.dtype)],
                            dim=-1)
        gates = self.ih(lstm_in) + self.hh(h)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        logits = torch.stack([getattr(self, f"fc_{m}")(h)
                              for m in range(self.num_modality)], dim=0)
        logits = logits.float()  # (M, N, 2)
        decision = gumbel_decision(generator, logits, tau)  # (M, N)
        nxt = logits.permute(1, 0, 2).reshape(h.shape[0], -1)
        return (h, c, nxt), (decision, logits)


class PolicyNet(nn.Module):
    """Inputs: per-modality policy streams, each (N, S, F, H, W, C) (sound:
    (N, S, 1, 256, T, 1)). Returns (decisions, logits) shaped (S, M, N) and
    (S, M, N, 2) (reference models/policy_net.py:372-373)."""

    def __init__(self, modality: Sequence[str], input_channels: Sequence[int],
                 causality_modeling: Optional[str] = "lstm",
                 use_pallas_dw: bool = False, remat_trunk: bool = False,
                 dtype: torch.dtype = torch.float32, bn_groups: int = 1):
        super().__init__()
        if causality_modeling not in (None, "lstm"):
            raise ValueError(
                f"unknown causality_modeling {causality_modeling!r}")
        self.modality = tuple(modality)
        self.causality_modeling = causality_modeling
        self.remat_trunk = remat_trunk
        self.dtype = dtype
        num_modality = len(self.modality)
        for m, ch in zip(self.modality, input_channels):
            self.add_module(f"net_{m}", MobileNetV2(
                temporal_pooling=True, use_pallas_dw=use_pallas_dw,
                dtype=dtype, input_channels=ch, head=False,
                bn_groups=bn_groups))
        trunk_dim = getattr(self, f"net_{self.modality[0]}").last_channel
        self.joint_fc1 = Dense(trunk_dim * num_modality, JOINT_DIM, dtype)
        self.joint_fc2 = Dense(JOINT_DIM, JOINT_DIM, dtype)
        if causality_modeling == "lstm":
            self.lstm = _DecisionCell(num_modality, dtype)
        else:
            for m in range(num_modality):
                self.add_module(f"fc_{m}", Dense(JOINT_DIM, 2, dtype))

    def forward(self, p_x: Sequence[torch.Tensor], temperature,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        num_modality = len(self.modality)
        n, s = p_x[0].shape[0], p_x[0].shape[1]
        feats = []
        for m, x in zip(self.modality, p_x):
            xf = x.reshape((n * s,) + tuple(x.shape[2:]))
            trunk = getattr(self, f"net_{m}")
            run = functools.partial(trunk, train=train, features=True,
                                    seq_groups=s)
            f = (remat(trunk, run, xf)
                 if remat_active(self.remat_trunk, train) else run(xf))
            feats.append(f.mean(dim=1))  # F_out == 1 in reference configs
        joint = torch.cat(feats, dim=-1).to(self.dtype)
        joint = torch.relu(self.joint_fc1(joint))
        joint = torch.relu(self.joint_fc2(joint))
        outs = joint.reshape(n, s, JOINT_DIM)
        # a tensor temperature stays on the device (a captured step reads
        # it at replay, train/steps.py); a number divides as before
        tau = (temperature if isinstance(temperature, torch.Tensor)
               else float(temperature))

        if self.causality_modeling is None:
            flat = outs.reshape(n * s, JOINT_DIM)
            logits = torch.stack([getattr(self, f"fc_{m}")(flat)
                                  for m in range(num_modality)], dim=0)
            logits = logits.float()  # (M, N*S, 2)
            decisions = gumbel_decision(generator, logits, tau)
            decisions = decisions.reshape(num_modality, n, s).permute(2, 0, 1)
            logits = logits.reshape(num_modality, n, s, 2).permute(2, 0, 1, 3)
            return decisions, logits

        h = torch.zeros(n, LSTM_HIDDEN, dtype=self.dtype, device=outs.device)
        carry = (h, torch.zeros_like(h),
                 torch.zeros(n, 2 * num_modality, device=outs.device))
        decisions, logits = [], []
        for t in range(s):
            carry, (dec, lg) = self.lstm(carry, outs[:, t], tau, generator)
            decisions.append(dec)
            logits.append(lg)
        return torch.stack(decisions), torch.stack(logits)
