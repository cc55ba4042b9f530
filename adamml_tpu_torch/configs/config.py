"""Configuration surface of the PyTorch port.

A copy of the typed dataclass configs of ``adamml_tpu/configs/config.py``
(same fields, defaults, constants and ``arch_name``), so a config built for
one package reads the same in the other. The argparse builder waits for the
CLI slice. ``flagship_cfg`` is the port's own copy of the canonical AdaMML
rgb+sound configuration.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

MODALITIES = ("rgb", "flow", "rgbdiff", "sound")

# Per-modality channel table (reference train_adamml.py:86-95):
# rgb = 3, flow = 2 channels x 5 consecutive frames, rgbdiff = 3 x 5, sound = 1.
_INPUT_CHANNELS = {"rgb": 3, "flow": 2 * 5, "rgbdiff": 3 * 5, "sound": 1}

# Consecutive-frame counts (reference utils/video_dataset.py:310-313).
NUM_CONSECUTIVE_FRAMES = {"rgb": 1, "sound": 1, "flow": 5, "rgbdiff": 5}

# Normalization constants (reference models/adamml.py:93-99).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FLOW_MEAN = (0.5,)
FLOW_STD = (sum(IMAGENET_STD) / 3.0,)


def input_channels_for(modality: str) -> int:
    return _INPUT_CHANNELS[modality]


@dataclasses.dataclass
class ModelConfig:
    """Model architecture flags (reference opts.py:9-35)."""

    backbone_net: str = "adamml"
    depth: int = 50
    dropout: float = 0.5
    groups: int = 8  # frames per segment
    num_segments: int = 1
    frames_per_group: int = 1  # dense: sampling stride
    without_t_stride: bool = False
    pooling_method: str = "max"  # 'avg' | 'max'
    fusion_point: str = "logits"  # 'fc2' | 'logits'
    prefix: str = ""
    learnable_lf_weights: bool = False
    causality_modeling: Optional[str] = None  # None | 'lstm'
    cost_weights: Optional[List[float]] = None
    rng_policy: bool = False
    rng_threshold: float = 0.5
    gammas: float = 10.0
    penalty_type: str = "blockdrop"  # 'mean' | 'blockdrop'
    modality: List[str] = dataclasses.field(default_factory=lambda: ["rgb"])
    num_classes: int = 31
    # policy-stream resolution (reference models/adamml.py:42 p_rgb_size)
    policy_input_size: int = 160
    # eval-only conditional compute; not ported yet (models/joint_net.py)
    eval_capacity: Optional[float] = None
    capacity_groups: Optional[int] = None
    # every 3x3 depthwise layer through the hand-written depthwise kernel
    # (ops/kernels/depthwise.py), with XLA's "SAME" padding
    use_pallas_dw: bool = False
    # fused stage-boundary bn-apply + add + relu + temporal max-pool kernel
    # (ops/kernels/tpool_fused.py); False runs the plain composition
    fused_tpool: bool = True
    remat_backbone: bool = False
    remat_stages: tuple = ()
    remat_policy: bool = True
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def input_channels(self) -> List[int]:
        return [input_channels_for(m) for m in self.modality]

    @property
    def major_modality(self) -> List[str]:
        """rgbdiff acts only as a policy proxy for flow when both are present
        (reference train_adamml.py:169-172)."""
        if "rgbdiff" in self.modality and "flow" in self.modality:
            return [m for m in self.modality if m != "rgbdiff"]
        return list(self.modality)


@dataclasses.dataclass
class OptimConfig:
    """Optimizer/schedule flags (reference opts.py:42-78)."""

    batch_size: int = 72  # global batch
    lr: float = 0.01
    p_lr: float = 0.01
    lr_scheduler: str = "cosine"  # step | multisteps | cosine | plateau
    lr_steps: List[float] = dataclasses.field(default_factory=lambda: [15, 30, 45])
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 1e-4
    epochs: int = 50
    warmup_epochs: int = 5
    finetune_epochs: int = 10
    clip_gradient: Optional[float] = None
    curr_stage: str = "warmup"  # warmup | alternative_training | finetune
    start_epoch: int = 0
    fused_update: bool = True
    steps_per_dispatch: int = 1


@dataclasses.dataclass
class DataConfig:
    """Data pipeline flags (reference opts.py:80-110, 118-128)."""

    datadir: List[str] = dataclasses.field(default_factory=list)
    dataset: str = "kinetics-sounds"
    threed_data: bool = False
    input_size: int = 224
    disable_scaleup: bool = False
    random_sampling: bool = False
    dense_sampling: bool = False
    augmentor_ver: str = "v2"
    scale_range: List[int] = dataclasses.field(default_factory=lambda: [256, 320])
    mean: Optional[List[float]] = None
    std: Optional[List[float]] = None
    skip_normalization: bool = False
    fps: float = 29.97
    audio_length: float = 1.28
    resampling_rate: float = 24000
    workers: int = 18
    num_crops: int = 1
    num_clips: int = 1
    val_num_clips: int = 10
    canvas_size: Tuple[int, int] = (256, 464)
    use_native_decoder: bool = True
    decode_threads: int = 1
    synthetic_length: int = 256  # videos in the synthetic dataset


@dataclasses.dataclass
class RuntimeConfig:
    """Logging / eval / distributed flags (reference opts.py:112-147)."""

    logdir: str = ""
    print_freq: int = 100
    show_model: bool = False
    evaluate: bool = False
    lazy_eval: bool = False
    after_softmax: bool = False
    pred_files: List[str] = dataclasses.field(default_factory=list)
    pred_weights: Optional[List[float]] = None
    sync_bn: bool = False
    world_size: int = 1
    rank: int = 0
    dist_url: str = ""
    hostfile: str = ""
    multiprocessing_distributed: bool = False
    resume: str = ""
    auto_resume: bool = False
    pretrained: Optional[str] = None
    unimodality_pretrained: List[str] = dataclasses.field(default_factory=list)
    mesh_data: int = -1
    mesh_model: int = 1
    seed: int = 0
    profile_dir: str = ""


@dataclasses.dataclass
class ExperimentConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)


def flagship_cfg(tiny: bool = False) -> ExperimentConfig:
    """Canonical AdaMML rgb+sound config (reference README.md:86-95): ResNet-50
    TSN + MobileNetV2, 5 segments, 8 frames/segment, LSTM causality, logits
    fusion with learnable late-fusion weights, 31 kinetics-sounds classes.
    ``tiny=True`` is the CPU parity size: depth 18, 4 frames, 2 segments,
    32x32, 5 classes, float32."""
    cfg = ExperimentConfig()
    cfg.model.backbone_net = "adamml"
    cfg.model.modality = ["rgb", "sound"]
    cfg.model.causality_modeling = "lstm"
    cfg.model.learnable_lf_weights = True
    cfg.model.cost_weights = [1.0, 0.05]
    cfg.model.num_segments = 5
    cfg.data.dense_sampling = True
    cfg.model.frames_per_group = 4
    cfg.runtime.sync_bn = True
    if tiny:
        cfg.model.depth = 18
        cfg.model.groups = 4
        cfg.model.num_segments = 2
        cfg.model.num_classes = 5
        cfg.model.policy_input_size = 24
        cfg.model.compute_dtype = "float32"
        cfg.data.input_size = 32
        cfg.data.audio_length = 0.16
        cfg.data.canvas_size = (64, 96)
        cfg.data.synthetic_length = 8
        cfg.data.workers = 2
        cfg.data.val_num_clips = 2
        cfg.data.dataset = "synthetic"
        cfg.optim.batch_size = 8
    return cfg


def _network_name(cfg: ExperimentConfig) -> str:
    m = cfg.model
    if m.backbone_net == "resnet":
        name = f"resnet-{m.depth}"
        if not m.without_t_stride:
            name += f"-ts-{m.pooling_method}"
        return name
    if m.backbone_net == "sound_mobilenet_v2":
        return "sound_mobilenet_v2"
    # adamml (reference models/adamml.py:101-109 + policy_net.py:375-379 +
    # joint_resnet_mobilenetv2.py:74-82)
    name = "adamml"
    if m.rng_policy:
        name += f"-rng-{m.rng_threshold:.1f}"
    else:
        name += "-j_mobilenet_v2"
        if m.causality_modeling:
            name += f"-{m.causality_modeling}"
    name += f"-joint_resnet-{m.depth}_mobilenet_v2-{m.fusion_point}"
    if m.fusion_point == "logits" and m.learnable_lf_weights:
        name += "-llf"
    if not m.without_t_stride:
        name += f"-ts-{m.pooling_method}"
    return name


def arch_name(cfg: ExperimentConfig, test_mode: bool = False) -> str:
    """Experiment identity string (reference models/model_builder.py:27-37)."""
    m, o, d, r = cfg.model, cfg.optim, cfg.data, cfg.runtime
    modality = "-".join(m.modality)
    name = f"{d.dataset}-{modality}-{_network_name(cfg)}"
    name += f"-f{m.groups}"
    if d.dense_sampling:
        name += f"-s{m.frames_per_group}"
    if not test_mode:
        name += "-{}{}-bs{}{}-e{}".format(
            o.lr_scheduler, "-syncbn" if r.sync_bn else "", o.batch_size,
            "-" + m.prefix if m.prefix else "", o.epochs)
    return name
