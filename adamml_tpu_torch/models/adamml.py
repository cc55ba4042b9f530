"""AdaMML wrapper (``adamml_tpu/models/adamml.py``): policy net + main net +
decision masking + segment mean.

Inputs arrive per modality as (N, S, F, H, W, C); the policy stream is built
on the device (bilinear resize + frame stride 2). The main net runs once
over all N*S segments folded clip-major into the batch. When both rgbdiff
and flow are requested the policy consumes rgbdiff and the main net flow
(reference models/adamml.py:143-152).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..configs.config import input_channels_for
from ..ops.augment import policy_stream
from ..parallel.mesh import local_noise
from .joint_net import JointMainNet
from .policy_net import PolicyNet

INIT_TEMPERATURE = 5.0       # reference models/policy_net.py:273
TEMPERATURE_DECAY = 0.965    # per alternating epoch, train_adamml.py:516


def split_modalities(modality: Sequence[str]
                     ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(policy modalities, main modalities) with the rgbdiff/flow proxy rule
    (reference models/adamml.py:143-152)."""
    modality = tuple(modality)
    if "rgbdiff" in modality and "flow" in modality:
        p = tuple(m for m in modality if m != "flow")
        m_ = tuple(m for m in modality if m != "rgbdiff")
        return p, m_
    return modality, modality


class AdaMML(nn.Module):
    def __init__(self, modality: Sequence[str], num_classes: int,
                 depth: int = 50, dropout: float = 0.5,
                 without_t_stride: bool = False, pooling_method: str = "max",
                 fusion_point: str = "logits",
                 learnable_lf_weights: bool = False,
                 causality_modeling: Optional[str] = "lstm",
                 rng_policy: bool = False, rng_threshold: float = 0.5,
                 policy_input_size: int = 160,
                 eval_capacity: Optional[float] = None,
                 capacity_groups: int = 1, data_shards: int = 1,
                 use_pallas_dw: bool = False, fused_tpool: bool = True,
                 remat: bool = False, remat_stages: Sequence[int] = (),
                 remat_policy: bool = True,
                 dtype: torch.dtype = torch.float32, bn_groups: int = 1):
        super().__init__()
        self.modality = tuple(modality)
        self.rng_policy = rng_policy
        self.rng_threshold = rng_threshold
        self.policy_input_size = policy_input_size
        p_mod, m_mod = split_modalities(self.modality)
        self.policy_net = None if rng_policy else PolicyNet(
            p_mod, [input_channels_for(m) for m in p_mod],
            causality_modeling=causality_modeling,
            use_pallas_dw=use_pallas_dw, remat_trunk=remat_policy,
            dtype=dtype, bn_groups=bn_groups)
        self.main_net = JointMainNet(
            m_mod, depth=depth, num_classes=num_classes, dropout=dropout,
            without_t_stride=without_t_stride, pooling_method=pooling_method,
            fusion_point=fusion_point,
            learnable_lf_weights=learnable_lf_weights,
            eval_capacity=eval_capacity, capacity_groups=capacity_groups,
            data_shards=data_shards,
            use_pallas_dw=use_pallas_dw,
            fused_tpool=fused_tpool, remat=remat, remat_stages=remat_stages,
            dtype=dtype, bn_groups=bn_groups)

    def forward(self, x: Sequence[torch.Tensor],
                temperature=INIT_TEMPERATURE, train: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None):
        """x: per-modality list, each (N, S, F, H, W, C); sound is
        (N, S, 1, 256, T, 1). Returns (logits (N, K) float32, decisions
        (N, S, M)) with M the number of MAIN modalities (reference
        models/adamml.py:69-91). ``generator`` draws the Gumbel (or
        rng-policy) noise on the inputs' device, ``dropout_generator`` the
        main net's dropout masks in train mode."""
        p_mod, m_mod = split_modalities(self.modality)
        mod = self.modality
        n, s = x[0].shape[0], x[0].shape[1]
        num_modality = len(m_mod)

        if self.rng_policy:
            # RNG baseline (reference models/adamml.py:74-78)
            u = local_noise(lambda shape: torch.rand(
                shape, generator=generator, device=x[0].device),
                (s, num_modality, n), dim=2)
            decisions = (u > self.rng_threshold).float()
        else:
            p_x = []
            for m in p_mod:
                t = x[mod.index(m)]
                if m != "sound":
                    t = policy_stream(t, size=self.policy_input_size,
                                      stride=2)
                p_x.append(t)
            decisions, _ = self.policy_net(p_x, temperature, train=train,
                                           generator=generator)  # (S, M, N)

        m_x = []
        for m in m_mod:
            t = x[mod.index(m)]
            m_x.append(t.reshape((n * s,) + tuple(t.shape[2:])))
        dec_flat = decisions.permute(1, 2, 0).reshape(num_modality, n * s)
        seg_logits = self.main_net(m_x, dec_flat, train=train, seq_groups=s,
                                   generator=dropout_generator)  # (N*S, K)
        final = seg_logits.reshape(n, s, -1).mean(dim=1)  # segment mean
        return final, decisions.permute(2, 0, 1)  # (N, K), (N, S, M)
