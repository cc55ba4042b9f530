"""Model factory (``adamml_tpu/models/model_builder.py``).

``build_model`` makes the module, fills it with seeded random weights
(``init_model``) and puts it on the device: CUDA unless the caller passes
``device="cpu"``. Inputs keep the JAX package's (N, S, F, H, W, C) layout.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from ..configs.config import ExperimentConfig, arch_name
from ..ops.spectrogram import SpectrogramConfig
from ..parallel.mesh import Shard, active, layout, model_group, shards_param
from ..utils.device import resolve_device
from .adamml import AdaMML
from .layers import Conv, Dense
from .mobilenet_v2 import MobileNetV2
from .mvit import MViT
from .norm import GroupedBatchNorm
from .resnet_tsn import ResNetTSN
from .slowfast import SlowFast

Device = Optional[Union[str, torch.device]]


def compute_dtype(cfg: ExperimentConfig) -> torch.dtype:
    return (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
            else torch.float32)


def _data_shards(cfg: ExperimentConfig) -> int:
    """Size of the data mesh, W / M: one shard a data index
    (parallel/mesh.py writes the world size into ``cfg.runtime``;
    adamml_tpu/models/model_builder.py:34-40)."""
    return max(1, max(1, cfg.runtime.world_size)
               // max(1, cfg.runtime.mesh_model))


def _capacity_groups(cfg: ExperimentConfig) -> int:
    """The global packing-group count for eval_capacity
    (models/joint_net.py): one group per data shard, as in the JAX
    package, unless --capacity_groups pins it, so capacity-eval accuracy
    does not depend on the device count. A count that is a multiple of the
    data shards packs each rank's rows alone; any other packs blocks that
    span ranks. The engine's capacity-drop count uses this same resolver
    (train/engine.py validate)."""
    g = cfg.model.capacity_groups
    if g is None:
        return _data_shards(cfg)
    if g < 1:
        raise ValueError(f"--capacity_groups must be >= 1, got {g}")
    return g


def _bn_groups(cfg: ExperimentConfig) -> int:
    """Moment groups of each rank's GroupedBatchNorm: 1. A rank's rows are
    one data shard, so its local moments are the JAX package's per-shard
    moments (per-replica BN, the reference's default); --sync-bn makes
    them global across ranks instead (models/norm.py ``sync``)."""
    return 1


def build_model(cfg: ExperimentConfig, device: Device = None,
                bn_groups: Optional[int] = None) -> Tuple[nn.Module, str]:
    """(model on ``device``, arch name). Weights are random from
    ``cfg.runtime.seed`` (``init_model``). ``bn_groups`` R > 1 gives every
    BN R moment groups in one process, the JAX package's one-process data
    mesh of R shards (the single-process reference of an R-rank run);
    default ``_bn_groups``. Under --sync-bn in a process group every BN
    takes its moments over all data shards. At --mesh_model M > 1 the full
    model is made from the seed as always, then each weight that
    ``shards_param`` names keeps its model index's rows (``shard_model``),
    so the M-way model is the single model, split."""
    dev = resolve_device(device)
    m = cfg.model
    dtype = compute_dtype(cfg)
    groups = _bn_groups(cfg) if bn_groups is None else bn_groups
    if m.backbone_net == "adamml":
        model = AdaMML(
            modality=tuple(m.modality), num_classes=m.num_classes,
            depth=m.depth, dropout=m.dropout,
            without_t_stride=m.without_t_stride,
            pooling_method=m.pooling_method, fusion_point=m.fusion_point,
            learnable_lf_weights=m.learnable_lf_weights,
            causality_modeling=m.causality_modeling, rng_policy=m.rng_policy,
            rng_threshold=m.rng_threshold,
            policy_input_size=m.policy_input_size,
            eval_capacity=m.eval_capacity,
            capacity_groups=_capacity_groups(cfg),
            data_shards=_data_shards(cfg),
            use_pallas_dw=m.use_pallas_dw,
            fused_tpool=m.fused_tpool, remat=m.remat_backbone,
            remat_stages=m.remat_stages, remat_policy=m.remat_policy,
            dtype=dtype, bn_groups=groups)
    elif m.backbone_net == "resnet":
        model = ResNetTSN(
            depth=m.depth, num_classes=m.num_classes, dropout=m.dropout,
            without_t_stride=m.without_t_stride,
            pooling_method=m.pooling_method, dtype=dtype,
            fused_tpool=m.fused_tpool, input_channels=m.input_channels[0],
            remat=m.remat_backbone, remat_stages=m.remat_stages,
            bn_groups=groups)
    elif m.backbone_net == "slowfast":
        model = SlowFast(depth=m.depth, num_classes=m.num_classes,
                         dropout=m.dropout, frames=m.groups, dtype=dtype,
                         bn_groups=groups)
    elif m.backbone_net == "mvit":
        model = MViT(num_classes=m.num_classes, dropout=m.dropout,
                     frames=m.groups, input_size=cfg.data.input_size,
                     dtype=dtype)
    elif m.backbone_net == "sound_mobilenet_v2":
        model = MobileNetV2(num_classes=m.num_classes, dropout=m.dropout,
                            use_pallas_dw=m.use_pallas_dw, dtype=dtype,
                            input_channels=m.input_channels[0],
                            bn_groups=groups)
    else:
        raise ValueError(f"unknown backbone_net {m.backbone_net!r}")
    init_model(model, cfg.runtime.seed)
    if cfg.runtime.sync_bn and active():
        for mod in model.modules():
            if isinstance(mod, GroupedBatchNorm):
                mod.sync = True
    return shard_model(model.to(dev)), arch_name(cfg)


def shard_model(model: nn.Module) -> nn.Module:
    """Cut every weight that ``shards_param`` names to this rank's rows
    over the joined run's model group (a no-op at --mesh_model 1)."""
    got = layout()
    if got.model > 1:
        shard = Shard(got.model, got.model_index, model_group())
        for name, mod in model.named_modules():
            if (isinstance(mod, Dense)
                    and shards_param(f"{name}.weight", mod.weight,
                                     got.model)):
                mod.shard_(shard)
    return model


def count_params_flops_summary(model: nn.Module, cfg: ExperimentConfig
                               ) -> str:
    """Params and the eval forward's GFLOPs at batch 1 (utils/flops.py's
    ``count_model_flops``), replacing the reference's torchsummary text
    (reference train_unimodal.py:127-134, utils/utils.py:98-108)."""
    from ..utils.flops import count_model_flops

    n_params = sum(p.numel() for p in model.parameters())
    dev = next(model.parameters()).device
    try:
        inputs = example_inputs(cfg, batch=1, device=dev)
        if cfg.model.backbone_net != "adamml":
            x = inputs[0]  # (N, S, F, ...) -> (N, S*F, ...)
            x = x.reshape((x.shape[0], x.shape[1] * x.shape[2])
                          + tuple(x.shape[3:]))
            flops = count_model_flops(model, x, train=False)
        else:
            flops = count_model_flops(
                model, inputs, train=False,
                generator=torch.Generator(device=dev).manual_seed(0))
        flops_str = f"Total flops: {flops / 1e9:.3f} GFLOPs (fwd, batch 1)"
    except Exception as e:  # the count is best-effort, as in the JAX CLI
        flops_str = f"Total flops: unavailable ({e})"
    return f"Total params: {n_params / 1e6:.3f}M\n{flops_str}"


@torch.no_grad()
def init_model(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init in place: conv and dense kernels
    N(0, 1/fan_in) (flax's lecun_normal scale), biases 0, BN scale 1 and
    bias 0 with running mean 0 / var 1, late-fusion weights 1/M. A model
    with rules of its own (SlowFast and MViT: PySlowFast's) has an
    ``init_weights`` that takes the generator instead."""
    gen = torch.Generator().manual_seed(seed)
    if hasattr(model, "init_weights"):
        model.init_weights(gen)
        return model
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense)):
            w = mod.weight
            fan_in = math.prod(w.shape[1:])
            w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))
            if isinstance(mod, Dense):
                mod.bias.zero_()
        elif isinstance(mod, GroupedBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        lf = getattr(mod, "lf_weights", None)
        if isinstance(lf, nn.Parameter):
            lf.fill_(1.0 / (lf.numel() + 1))
    return model


def modality_input_shape(cfg: ExperimentConfig, modality: str, batch: int,
                         num_segments: int) -> Tuple[int, ...]:
    """Canonical input shape for one modality: visual (N, S, F, H, W, C)
    with C = 3 (rgb), 10 (flow), 15 (rgbdiff); sound (N, S, 1, 256, T, 1)
    log-spectrogram per segment."""
    g = cfg.model.groups
    size = cfg.data.input_size
    if modality == "sound":
        spec = SpectrogramConfig(
            resampling_rate=int(cfg.data.resampling_rate),
            audio_length=cfg.data.audio_length)
        return (batch, num_segments, 1, spec.num_freqs, spec.num_frames, 1)
    channels = {"rgb": 3, "flow": 10, "rgbdiff": 15}[modality]
    return (batch, num_segments, g, size, size, channels)


def example_inputs(cfg: ExperimentConfig, batch: int = 2,
                   num_segments: Optional[int] = None, seed: int = 0,
                   device: Device = None) -> List[torch.Tensor]:
    """Standard-normal float32 inputs with the canonical shapes, one per
    modality, drawn on the device from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    s = num_segments if num_segments is not None else cfg.model.num_segments
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(modality_input_shape(cfg, m, batch, s),
                        generator=gen, device=dev)
            for m in cfg.model.modality]
