"""Configuration surface of the PyTorch port.

A copy of the typed dataclass configs of ``adamml_tpu/configs/config.py``
(same fields, defaults, constants and ``arch_name``), so a config built for
one package reads the same in the other, and of its argument parser: the
same flags, so a training command of either package parses in the other.
``validate_args`` gives each flag value the port cannot run a loud
``ValueError`` that names it.
``flagship_cfg`` is the port's own copy of the canonical AdaMML rgb+sound
configuration.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Tuple

from .dataset_config import DATASET_CONFIG, get_dataset_config

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


def modality_mean(modality: str) -> Tuple[float, ...]:
    return IMAGENET_MEAN if modality in ("rgb", "rgbdiff") else FLOW_MEAN


def modality_std(modality: str) -> Tuple[float, ...]:
    return IMAGENET_STD if modality in ("rgb", "rgbdiff") else FLOW_STD


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
    # eval-only conditional compute (models/joint_net.py)
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
    # the main net's optimizer (the port's own flag): sgd, or adamw with
    # decoupled decay and none on 1-D parameters
    optimizer: str = "sgd"


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
    if m.backbone_net == "slowfast":
        return f"slowfast-r{m.depth}"
    if m.backbone_net == "mvit":
        return "mvitv2-s"
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


def arg_parser() -> argparse.ArgumentParser:
    """CLI flags: the JAX package's parser (``adamml_tpu/configs/config.py``
    ``arg_parser``), flag for flag, names matching the reference parser
    (reference opts.py:5-149). What each flag means on one CUDA card:
    README.md's port section."""
    p = argparse.ArgumentParser(description="AdaMML training on a CUDA card")

    # model
    p.add_argument("--backbone_net", default="adamml", type=str,
                   choices=["adamml", "resnet", "sound_mobilenet_v2",
                            "slowfast", "mvit"])
    p.add_argument("-d", "--depth", default=50, type=int,
                   choices=[18, 34, 50, 101, 152])
    p.add_argument("--dropout", default=0.5, type=float)
    p.add_argument("--groups", default=8, type=int)
    p.add_argument("--num_segments", default=1, type=int)
    p.add_argument("--frames_per_group", default=1, type=int)
    p.add_argument("--without_t_stride", action="store_true")
    p.add_argument("--pooling_method", default="max", choices=["avg", "max"])
    p.add_argument("--fusion_point", default="logits", choices=["fc2", "logits"])
    p.add_argument("--prefix", default="", type=str)
    p.add_argument("--learnable_lf_weights", action="store_true")
    p.add_argument("--causality_modeling", default=None, type=str,
                   choices=[None, "lstm"])
    p.add_argument("--cost_weights", default=None, type=float, nargs="+")
    p.add_argument("--rng_policy", action="store_true")
    p.add_argument("--rng_threshold", type=float, default=0.5)
    p.add_argument("--gammas", default=10.0, type=float)
    p.add_argument("--penalty_type", default="blockdrop", choices=["mean", "blockdrop"])
    p.add_argument("--eval_capacity", default=None, type=float,
                   help="eval-only conditional compute: the fraction of "
                        "rows per modality whose backbone runs")
    p.add_argument("--capacity_groups", default=None, type=int,
                   help="pin the eval_capacity packing-group count "
                        "(default: one group a rank)")
    p.add_argument("--use_pallas_dw", action="store_true",
                   help="every 3x3 depthwise layer through the hand-written "
                        "CUDA depthwise kernel")
    p.add_argument("--no_fused_tpool", action="store_true",
                   help="the plain composition instead of the fused "
                        "stage-boundary kernels")
    p.add_argument("--no_remat_policy", action="store_true",
                   help="keep policy-trunk activations for backward instead "
                        "of rematerializing them (more memory, no recompute)")
    p.add_argument("--remat_backbone", action="store_true")
    p.add_argument("--remat_stages", nargs="+", type=int, default=[],
                   choices=(1, 2, 3, 4), metavar="STAGE",
                   help="rematerialize only these ResNet stages (1-based); "
                        "cheaper than --remat_backbone for memory headroom")

    # training
    p.add_argument("-b", "--batch-size", dest="batch_size", default=72, type=int)
    p.add_argument("--lr", "--learning-rate", dest="lr", default=0.01, type=float)
    p.add_argument("--p_lr", "--p_learning-rate", dest="p_lr", default=0.01, type=float)
    p.add_argument("--lr_scheduler", default="cosine",
                   choices=["step", "multisteps", "cosine", "plateau"])
    p.add_argument("--lr_steps", default=[15, 30, 45], type=float, nargs="+")
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--nesterov", action="store_true")
    p.add_argument("--weight-decay", "--wd", dest="weight_decay", default=1e-4, type=float)
    p.add_argument("--epochs", default=50, type=int)
    p.add_argument("--warmup_epochs", default=5, type=int)
    p.add_argument("--finetune_epochs", default=10, type=int)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--pretrained", default=None, type=str,
                   help="a checkpoint directory of this package: its "
                        "parameters, BN statistics and temperature, grafted "
                        "by name and shape")
    p.add_argument("--unimodality_pretrained", type=str, nargs="+", default=[],
                   help="one unimodal checkpoint per modality (a checkpoint "
                        "directory of this package or a reference "
                        ".pth/.pth.tar/.pt), loaded strictly into "
                        "main_net.net_<modality>")
    p.add_argument("--start-epoch", dest="start_epoch", default=0, type=int)
    p.add_argument("--clip_gradient", "--cg", dest="clip_gradient", default=None, type=float)
    p.add_argument("--curr_stage", default="warmup",
                   choices=["warmup", "alternative_training", "finetune"])
    p.add_argument("--no_fused_update", action="store_true",
                   help="torch optimizers with foreach=False (one kernel "
                        "per tensor) instead of the multi-tensor foreach "
                        "update")
    p.add_argument("--steps_per_dispatch", default=1, type=int,
                   help="K real optimizer steps per dispatch (on a CUDA "
                        "card one replayed CUDA graph)")
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"],
                   help="train_unimodal's optimizer: SGD (--momentum, "
                        "L2 --wd in the gradient) or AdamW (decoupled --wd, "
                        "none on 1-D parameters)")

    # data
    p.add_argument("-j", "--workers", default=18, type=int)
    p.add_argument("--datadir", nargs="+", type=str, default=[])
    p.add_argument("--dataset", default="kinetics-sounds",
                   choices=list(DATASET_CONFIG.keys()))
    p.add_argument("--threed_data", action="store_true")
    p.add_argument("--input_size", default=224, type=int)
    p.add_argument("--disable_scaleup", action="store_true")
    p.add_argument("--random_sampling", action="store_true")
    p.add_argument("--dense_sampling", action="store_true")
    p.add_argument("--augmentor_ver", default="v2",
                   choices=["v1", "v2", "random_sized"])
    p.add_argument("--scale_range", default=[256, 320], type=int, nargs="+")
    p.add_argument("--modality", default=["rgb"], type=str, nargs="+",
                   choices=list(MODALITIES))
    p.add_argument("--mean", type=float, nargs="+", default=None)
    p.add_argument("--std", type=float, nargs="+", default=None)
    p.add_argument("--skip_normalization", action="store_true")
    p.add_argument("--fps", type=float, default=29.97)
    p.add_argument("--audio_length", type=float, default=1.28)
    p.add_argument("--resampling_rate", type=float, default=24000)
    p.add_argument("--synthetic_length", type=int, default=256)
    p.add_argument("--disable_native_decoder", action="store_true")
    p.add_argument("--decode_threads", default=1, type=int,
                   help="native JPEG decode threads per sample")

    # logging
    p.add_argument("--logdir", default="", type=str)
    p.add_argument("--print-freq", dest="print_freq", default=100, type=int)
    p.add_argument("--show_model", action="store_true")

    # eval
    p.add_argument("-e", "--evaluate", action="store_true")
    p.add_argument("--num_crops", default=1, type=int, choices=[1, 3, 5, 10])
    p.add_argument("--num_clips", default=1, type=int)
    p.add_argument("--val_num_clips", default=10, type=int)
    p.add_argument("--pred_files", type=str, nargs="+", default=[],
                   help="score saved val_*.npy logits (an ensemble) against "
                        "the val list instead of training")
    p.add_argument("--pred_weights", type=float, nargs="+", default=None)
    p.add_argument("--after_softmax", action="store_true")
    p.add_argument("--lazy_eval", action="store_true")

    # devices and processes
    p.add_argument("--gpu", default=None, type=str,
                   help="the CUDA device(s) to run on, comma-separated")
    p.add_argument("--gpu_id", default=None, type=str,
                   help="the CUDA device(s) to run on, comma-separated")
    p.add_argument("--disable_cudnn_benchmark", action="store_true",
                   help="accepted; the port never turns cudnn.benchmark on")
    p.add_argument("--dist-backend", dest="dist_backend", default=None,
                   type=str, help="nccl (default on CUDA) or gloo")
    p.add_argument("--multiprocessing-distributed", "--multiprocessing_distributed",
                   dest="multiprocessing_distributed", action="store_true",
                   help="spawn one process per device (--gpu ids, else "
                        "every visible card)")
    p.add_argument("--sync-bn", dest="sync_bn", action="store_true",
                   help="BN moments over all ranks (default: per rank)")
    p.add_argument("--world-size", dest="world_size", default=1, type=int)
    p.add_argument("--rank", default=0, type=int)
    p.add_argument("--dist-url", dest="dist_url", default="", type=str)
    p.add_argument("--hostfile", default="", type=str)
    p.add_argument("--mesh_data", default=-1, type=int,
                   help="-1 or the world size over --mesh_model: the data "
                        "shards")
    p.add_argument("--mesh_model", default=1, type=int,
                   help="ranks a tensor-parallel group (dividing the world "
                        "size): the wide Dense weights are split over them")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--profile_dir", default="", type=str,
                   help="write a torch.profiler trace of steps 2-4 of each "
                        "curriculum pass's first epoch here")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    return p


def gpu_ids(args: argparse.Namespace) -> List[str]:
    """The CUDA device ids ``--gpu``/``--gpu_id`` name, in order."""
    pick = args.gpu_id or args.gpu
    return [g.strip() for g in pick.split(",") if g.strip()] if pick else []


def validate_args(parser: argparse.ArgumentParser,
                  args: argparse.Namespace) -> None:
    """The JAX package's checks (the same argv fails through
    ``parser.error``), then a ``ValueError`` naming each flag that the port
    cannot run: --mesh_model that does not divide the world size,
    --mesh_data other than -1 or the world size over it, and two devices
    outside --multiprocessing-distributed; and for --backbone_net slowfast
    and mvit what each cannot take (``_check_slowfast``, ``_check_mvit``)."""
    if args.threed_data:
        parser.error("--threed_data loads clips in the (C, T, H, W) layout "
                     "of a 3D backbone that the model table lacks (the "
                     "reference's default 's3d' is absent from its "
                     "MODEL_TABLE as well); the port's 3D model, "
                     "--backbone_net slowfast, takes the port's own "
                     "(N, S, F, H, W, C) layout without the flag")
    if args.pred_weights is not None and not args.pred_files:
        parser.error("--pred_weights requires --pred_files")
    if args.after_softmax and not args.pred_files:
        parser.error("--after_softmax only applies to --pred_files "
                     "ensemble scoring")
    if (args.pred_files and args.pred_weights is not None
            and len(args.pred_weights) != len(args.pred_files)):
        parser.error("--pred_weights must have one weight per --pred_files "
                     "entry")
    if (args.num_segments > 1 and not args.dense_sampling
            and not args.evaluate):
        # the reference's uniform train sampler returns one clip of `groups`
        # frames (utils/video_dataset.py:154-168)
        parser.error("--num_segments > 1 training requires --dense_sampling "
                     "(uniform train sampling yields one clip, matching "
                     "reference utils/video_dataset.py:154-168)")
    if args.backbone_net == "slowfast":
        _check_slowfast(args)
    if args.backbone_net == "mvit":
        _check_mvit(args)
    if args.mesh_model < 1:
        raise ValueError(f"--mesh_model {args.mesh_model} must be at least 1")
    # the world size is known here unless a hostfile or the spawn sets it
    # (parallel/mesh.py::init_distributed checks again then)
    if not args.hostfile and not args.multiprocessing_distributed:
        w, m = args.world_size, args.mesh_model
        if w % m:
            raise ValueError(f"--mesh_model {m} does not divide the world "
                             f"size ({w})")
        if args.mesh_data not in (-1, w // m):
            raise ValueError(f"--mesh_data {args.mesh_data} must be -1 or "
                             f"the world size over --mesh_model ({w} / {m}): "
                             f"the data shards")
    ids = gpu_ids(args)
    if len(set(ids)) != len(ids):
        raise ValueError(f"--gpu/--gpu_id name a device twice: {ids}")
    if len(ids) > 1 and not args.multiprocessing_distributed:
        raise ValueError(f"--gpu/--gpu_id name {len(ids)} devices: one "
                         f"process runs on one device; "
                         f"--multiprocessing-distributed spawns one process "
                         f"on each")
    if args.num_crops > 1 and all(m == "sound" for m in args.modality):
        print("WARNING: --num_crops > 1 with a sound-only modality set "
              "replicates spectrogram rows (sound has no spatial crops); "
              "results are identical to --num_crops 1 at num_crops x the "
              "eval compute", flush=True)
    if args.disable_cudnn_benchmark:
        print("WARNING: --disable_cudnn_benchmark has no effect in the port "
              "(cudnn.benchmark left off)", flush=True)


def _check_slowfast(args: argparse.Namespace) -> None:
    """What SlowFast (models/slowfast.py) cannot take: other modalities
    than rgb, more than one segment (a clip is one segment of --groups
    frames), a frame count the slow pathway's stride 4 does not divide,
    another depth than 50."""
    if list(args.modality) != ["rgb"]:
        raise ValueError(f"--backbone_net slowfast takes --modality rgb, "
                         f"not {' '.join(args.modality)}")
    if args.num_segments != 1:
        raise ValueError(f"--backbone_net slowfast takes --num_segments 1 "
                         f"(one clip of --groups frames), not "
                         f"{args.num_segments}")
    if args.groups % 4:
        raise ValueError(f"--backbone_net slowfast needs --groups (the "
                         f"clip's frames) divisible by 4, the slow "
                         f"pathway's frame stride; got {args.groups}")
    if args.depth != 50:
        raise ValueError(f"--backbone_net slowfast is built at -d/--depth "
                         f"50 only, not {args.depth}")


def _check_mvit(args: argparse.Namespace) -> None:
    """What MViTv2-S 16x4 (models/mvit.py) cannot take: other modalities
    than rgb, more than one segment, a clip of other than 16 frames, crops
    of other than 224 px (its relative-position tables are sized for the
    token grid of 16 x 224 x 224), a depth flag other than the default
    (the model has one depth, 16 blocks)."""
    if list(args.modality) != ["rgb"]:
        raise ValueError(f"--backbone_net mvit takes --modality rgb, not "
                         f"{' '.join(args.modality)}")
    if args.num_segments != 1:
        raise ValueError(f"--backbone_net mvit takes --num_segments 1 (one "
                         f"clip of --groups frames), not {args.num_segments}")
    if args.groups != 16:
        raise ValueError(f"--backbone_net mvit takes --groups 16 (the "
                         f"clip's frames), not {args.groups}")
    if args.input_size != 224:
        raise ValueError(f"--backbone_net mvit takes --input_size 224, not "
                         f"{args.input_size}")
    if args.depth != 50:
        raise ValueError(f"--backbone_net mvit has one depth (16 blocks): "
                         f"leave -d/--depth at its default, not "
                         f"{args.depth}")


def cuda_device(args: argparse.Namespace, local_rank: int = 0) -> str:
    """The CUDA device of the process with ``local_rank`` on this node:
    the id ``--gpu``/``--gpu_id`` name at that index (default: the current
    device)."""
    ids = gpu_ids(args)
    return f"cuda:{ids[local_rank]}" if ids else "cuda"


def run_devices(args: argparse.Namespace, device=None) -> List[str]:
    """The devices a CLI runs on, one process each: the one ``device``
    names (the CPU for the tests), else ``cuda_device``; with
    --multiprocessing-distributed every id --gpu names, else every visible
    card (on the CPU, one process per named id, else one)."""
    ids = gpu_ids(args)
    if not args.multiprocessing_distributed:
        return [cuda_device(args) if device is None else str(device)]
    if device is not None:
        return [str(device)] * max(1, len(ids))
    if ids:
        return [cuda_device(args, i) for i in range(len(ids))]
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    meta = get_dataset_config(args.dataset)
    model = ModelConfig(
        backbone_net=args.backbone_net, depth=args.depth, dropout=args.dropout,
        groups=args.groups, num_segments=args.num_segments,
        frames_per_group=args.frames_per_group,
        without_t_stride=args.without_t_stride,
        pooling_method=args.pooling_method, fusion_point=args.fusion_point,
        prefix=args.prefix, learnable_lf_weights=args.learnable_lf_weights,
        causality_modeling=args.causality_modeling, cost_weights=args.cost_weights,
        rng_policy=args.rng_policy, rng_threshold=args.rng_threshold,
        gammas=args.gammas, penalty_type=args.penalty_type,
        modality=list(args.modality), num_classes=meta.num_classes,
        eval_capacity=args.eval_capacity,
        capacity_groups=args.capacity_groups,
        use_pallas_dw=args.use_pallas_dw,
        fused_tpool=not args.no_fused_tpool,
        remat_backbone=args.remat_backbone,
        remat_stages=tuple(args.remat_stages),
        remat_policy=not args.no_remat_policy,
        compute_dtype=args.compute_dtype,
    )
    optim = OptimConfig(
        batch_size=args.batch_size, lr=args.lr, p_lr=args.p_lr,
        lr_scheduler=args.lr_scheduler, lr_steps=list(args.lr_steps),
        momentum=args.momentum, nesterov=args.nesterov,
        weight_decay=args.weight_decay, epochs=args.epochs,
        warmup_epochs=args.warmup_epochs, finetune_epochs=args.finetune_epochs,
        clip_gradient=args.clip_gradient, curr_stage=args.curr_stage,
        start_epoch=args.start_epoch,
        fused_update=not args.no_fused_update,
        steps_per_dispatch=args.steps_per_dispatch,
        optimizer=args.optimizer,
    )
    data = DataConfig(
        datadir=list(args.datadir), dataset=args.dataset,
        threed_data=args.threed_data, input_size=args.input_size,
        disable_scaleup=args.disable_scaleup,
        random_sampling=args.random_sampling, dense_sampling=args.dense_sampling,
        augmentor_ver=args.augmentor_ver, scale_range=list(args.scale_range),
        mean=args.mean, std=args.std, skip_normalization=args.skip_normalization,
        fps=args.fps, audio_length=args.audio_length,
        resampling_rate=args.resampling_rate, workers=args.workers,
        num_crops=args.num_crops, num_clips=args.num_clips,
        val_num_clips=args.val_num_clips,
        synthetic_length=args.synthetic_length,
        use_native_decoder=not args.disable_native_decoder,
        decode_threads=args.decode_threads,
    )
    runtime = RuntimeConfig(
        logdir=args.logdir, print_freq=args.print_freq, show_model=args.show_model,
        evaluate=args.evaluate, lazy_eval=args.lazy_eval,
        after_softmax=args.after_softmax, pred_files=list(args.pred_files),
        pred_weights=args.pred_weights, sync_bn=args.sync_bn,
        world_size=args.world_size, rank=args.rank, dist_url=args.dist_url,
        hostfile=args.hostfile,
        multiprocessing_distributed=args.multiprocessing_distributed,
        resume=args.resume, auto_resume=args.auto_resume,
        pretrained=args.pretrained,
        unimodality_pretrained=list(args.unimodality_pretrained),
        mesh_data=args.mesh_data, mesh_model=args.mesh_model, seed=args.seed,
        profile_dir=args.profile_dir,
    )
    return ExperimentConfig(model=model, optim=optim, data=data, runtime=runtime)
