"""Main (recognition) network (``adamml_tpu/models/joint_net.py``).

ResNet TSN for visual modalities, MobileNetV2 for sound; fusion at
``logits`` (decision-masked per-modality logits, mean or learnable-weighted
sum) or at ``fc2`` (feature concat -> 2-layer MLP -> classifier, no decision
support). The learnable late-fusion weight is a length M-1 parameter
initialized to 1/M whose complement makes the weights sum to 1 (reference
joint_resnet_mobilenetv2.py:60-64,115-125).

``eval_capacity`` below 1 is eval-only conditional compute: per modality,
the rows the decisions select are packed into ``cap`` rows of each of
``capacity_groups`` contiguous blocks of the global batch, the backbone
runs on those rows only, and their logits scatter back (the rows that did
not run give 0; a selection beyond ``cap`` in a block degrades to decision
0). The reference only models the saving (reference
models/adamml.py:82-86). Over ``data_shards`` D ranks a count that is a
multiple of D packs each rank's rows alone; any other count makes blocks
that span ranks, and every rank plans them from the gathered decisions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..configs.config import input_channels_for
from ..ops.dropout import dropout
from ..parallel.mesh import data_world, gather_rows
from .layers import Dense
from .mobilenet_v2 import MobileNetV2
from .resnet_tsn import ResNetTSN

JOINT_DIM = 2048  # reference joint_resnet_mobilenetv2.py:53


class JointMainNet(nn.Module):
    """Inputs: per-modality tensors (B, F, H, W, C) with segments folded into
    B (sound: (B, 1, 256, T, 1)); optional decisions (M, B). Returns logits
    (B, num_classes) float32."""

    def __init__(self, modality: Sequence[str], depth: int = 50,
                 num_classes: int = 1000, dropout: float = 0.5,
                 without_t_stride: bool = False, pooling_method: str = "max",
                 fusion_point: str = "logits",
                 learnable_lf_weights: bool = False,
                 eval_capacity: Optional[float] = None,
                 capacity_groups: int = 1, data_shards: int = 1,
                 use_pallas_dw: bool = False, fused_tpool: bool = True,
                 remat: bool = False, remat_stages: Sequence[int] = (),
                 dtype: torch.dtype = torch.float32, bn_groups: int = 1):
        super().__init__()
        if fusion_point not in ("logits", "fc2"):
            raise ValueError(f"unknown fusion_point {fusion_point!r}")
        self.modality = tuple(modality)
        self.fusion_point = fusion_point
        self.eval_capacity = eval_capacity
        self.num_classes = num_classes
        self.capacity_groups = capacity_groups
        self.data_shards = data_shards
        self.dropout = dropout
        self.dtype = dtype
        logits_head = fusion_point == "logits"
        feat_dim = 0
        for m in self.modality:
            if m == "sound":
                net = MobileNetV2(num_classes=num_classes, dropout=dropout,
                                  use_pallas_dw=use_pallas_dw, dtype=dtype,
                                  input_channels=1, head=logits_head,
                                  bn_groups=bn_groups)
                feat_dim += net.last_channel
            else:
                net = ResNetTSN(depth=depth, num_classes=num_classes,
                                dropout=dropout,
                                without_t_stride=without_t_stride,
                                pooling_method=pooling_method, dtype=dtype,
                                fused_tpool=fused_tpool,
                                input_channels=input_channels_for(m),
                                head=logits_head, remat=remat,
                                remat_stages=remat_stages,
                                bn_groups=bn_groups)
                feat_dim += net.feature_dim
            self.add_module(f"net_{m}", net)
        if logits_head:
            self.lf_weights = (nn.Parameter(torch.full(
                (len(self.modality) - 1,), 1.0 / len(self.modality)))
                if learnable_lf_weights else None)
        else:
            self.joint_fc1 = Dense(feat_dim, JOINT_DIM, dtype)
            self.joint_fc2 = Dense(JOINT_DIM, JOINT_DIM, dtype)
            self.fc = Dense(JOINT_DIM, num_classes, dtype)

    def forward(self, m_x: Sequence[torch.Tensor],
                decisions: Optional[torch.Tensor] = None,
                train: bool = False, seq_groups: int = 1,
                generator: Optional[torch.Generator] = None):
        """``seq_groups``: segments folded clip-major into B (train-mode BN
        moments are per segment); ``generator`` draws the dropout masks in
        train mode, backbone by backbone."""

        def run(i, features=False):
            return getattr(self, f"net_{self.modality[i]}")(
                m_x[i], train, features=features, seq_groups=seq_groups,
                generator=generator)

        use_packing = (self.eval_capacity is not None and not train
                       and decisions is not None
                       and self.fusion_point == "logits"
                       and self.eval_capacity < 1.0)
        if self.fusion_point == "logits":
            outs = []
            for i, m in enumerate(self.modality):
                if use_packing:
                    logit = self._packed(i, m_x[i], decisions[i])
                else:
                    logit = run(i)  # (B, K)
                    if decisions is not None:
                        # mask at logits; backbones always run (reference
                        # joint_resnet_mobilenetv2.py:92-94)
                        logit = logit * decisions[i][:, None]
                outs.append(logit)
            out = torch.stack(outs, dim=0)  # (M, B, K)
            if self.lf_weights is not None:
                lf = self.lf_weights
                weights = torch.cat([lf, (1.0 - lf.sum())[None]], dim=0)
                return (out * weights[:, None, None]).sum(dim=0)
            return out.mean(dim=0)

        # fc2 fusion (reference joint_resnet_mobilenetv2.py:99-110)
        if decisions is not None:
            raise ValueError("decision masking only supports logits fusion")
        feats = []
        for i, m in enumerate(self.modality):
            f = run(i, features=True)
            if m != "sound":
                f = f.mean(dim=(2, 3))  # spatial avgpool -> (B, F_out, C)
            feats.append(f.mean(dim=1))
        out = torch.cat(feats, dim=-1).to(self.dtype)
        out = torch.relu(self.joint_fc1(out))
        out = torch.relu(self.joint_fc2(out))
        out = dropout(out, self.dropout, train, generator)
        return self.fc(out).float()

    def _packed(self, i: int, x: torch.Tensor, dec: torch.Tensor
                ) -> torch.Tensor:
        """Modality ``i``'s decision-masked logits (B, K) with its backbone
        run on ``cap`` rows of each of G blocks of the global batch of
        B x D rows (G = capacity_groups when it divides them, else 1;
        cap = max(1, round(c * B x D / G))): a stable descending argsort of
        each block's decisions puts the selected rows first, ties in index
        order; the first cap rows run, their logits times their decisions
        scatter back, and the other rows get 0. When the blocks fall within
        ranks (D divides G) a rank packs its own B rows in G / D blocks;
        otherwise ``_packed_across``."""
        b, d = x.shape[0], self.data_shards
        g = self.capacity_groups
        if not (g > 1 and (b * d) % g == 0):
            g = 1
        if d > 1 and g % d:
            return self._packed_across(i, x, dec, g)
        g //= d
        bl = b // g
        cap = max(1, int(round(self.eval_capacity * bl)))
        dec = dec.reshape(g, bl)
        order = torch.argsort(-dec, dim=1, stable=True)
        idx = order[:, :cap]                                   # (G, cap)
        rows = torch.arange(g, device=x.device)[:, None]
        xp = x.reshape((g, bl) + tuple(x.shape[1:]))[rows, idx]
        # eval-mode BN reads no batch moments: the packed rows form no
        # segment cycles (seq_groups 1)
        lp = getattr(self, f"net_{self.modality[i]}")(
            xp.reshape((g * cap,) + tuple(x.shape[1:])), False)
        k = lp.shape[-1]
        lp = lp.reshape(g, cap, k) * torch.gather(dec, 1, idx)[..., None]
        lp_sorted = torch.cat([lp, lp.new_zeros((g, bl - cap, k))], dim=1)
        inv = torch.argsort(order, dim=1)
        return torch.gather(lp_sorted, 1,
                            inv[..., None].expand(g, bl, k)).reshape(b, k)

    def _packed_across(self, i: int, x: torch.Tensor, dec: torch.Tensor,
                       g: int) -> torch.Tensor:
        """``_packed`` for blocks that span ranks: the data shards'
        decisions gathered (one value a row), every rank makes the same
        global plan and runs its backbone only on its own rows of the run
        set (none: no launch), so no input row moves between ranks. A row's
        eval logits depend on that row alone (eval BN reads running
        statistics), so this computes the single-device function."""
        shards, index = data_world()
        if shards != self.data_shards:
            raise ValueError(f"the model packs over {self.data_shards} data "
                             f"shards, the process group has {shards}")
        b = x.shape[0]
        every = gather_rows(dec).to(dec.device)                # (B x D,)
        bl = every.shape[0] // g
        cap = max(1, int(round(self.eval_capacity * bl)))
        order = torch.argsort(-every.reshape(g, bl), dim=1, stable=True)
        run = (order[:, :cap]
               + bl * torch.arange(g, device=dec.device)[:, None]).flatten()
        mine = run[(run >= index * b) & (run < (index + 1) * b)] - index * b
        net = getattr(self, f"net_{self.modality[i]}")
        if mine.numel() == 0:
            return torch.zeros((b, self.num_classes), dtype=torch.float32,
                               device=x.device)
        lp = net(x[mine], False) * dec[mine][:, None]
        return lp.new_zeros((b, lp.shape[-1])).index_copy_(0, mine, lp)
