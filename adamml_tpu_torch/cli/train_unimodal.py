"""Unimodal pretraining CLI on CUDA cards (reference train_unimodal.py;
``adamml_tpu/cli/train_unimodal.py``).

Trains a single backbone (resnet for rgb/flow/rgbdiff, sound_mobilenet_v2
for sound, unless --backbone_net names one; slowfast, the 3D SlowFast 8x8
R50 of models/slowfast.py, or mvit, MViTv2-S 16x4 of models/mvit.py, for
rgb clips), with SGD or, under --optimizer adamw, AdamW. Mean/std overrides are
validated like the reference (train_unimodal.py:100-117). Runs on CUDA
unless ``main`` is given ``device="cpu"``; multi-process runs as
train_adamml's.

  python -m adamml_tpu_torch.cli.train_unimodal --dataset synthetic \
      --modality rgb --backbone_net resnet -d 50 --groups 8 -b 8 ...
  python -m adamml_tpu_torch.cli.train_unimodal --dataset kinetics400 \
      --datadir DIR --modality rgb --backbone_net slowfast -d 50 \
      --groups 32 --frames_per_group 2 --num_segments 1 --dense_sampling \
      -b 64 --lr 0.8 ...
  python -m adamml_tpu_torch.cli.train_unimodal --dataset kinetics400 \
      --datadir DIR --modality rgb --backbone_net mvit --groups 16 \
      --frames_per_group 4 --num_segments 1 --dense_sampling \
      --optimizer adamw --wd 0.05 --clip_gradient 1.0 \
      --augmentor_ver random_sized -b 32 --lr 4e-4 ...
"""

from __future__ import annotations

import sys

from ..configs.config import (arg_parser, config_from_args, run_devices,
                              validate_args)
from ..parallel import mesh
from .train_adamml import init_distributed


def main(argv=None, device=None) -> int:
    parser = arg_parser()
    args = parser.parse_args(argv)
    validate_args(parser, args)
    cfg = config_from_args(args)
    if len(cfg.model.modality) != 1:
        raise ValueError("train_unimodal takes exactly one --modality")
    m = cfg.model.modality[0]
    if cfg.model.backbone_net == "adamml":
        cfg.model.backbone_net = ("sound_mobilenet_v2" if m == "sound"
                                  else "resnet")
    if cfg.data.mean is not None and len(cfg.data.mean) not in (1, 3):
        raise ValueError("mean must have 1 or 3 entries")
    if cfg.data.std is not None and len(cfg.data.std) not in (1, 3):
        raise ValueError("std must have 1 or 3 entries")
    if cfg.runtime.pretrained or cfg.runtime.unimodality_pretrained:
        raise ValueError("--pretrained and --unimodality_pretrained load "
                         "into the AdaMML model: train_adamml takes them")
    return mesh.launch(run, cfg, run_devices(args, device),
                       args.dist_backend, args.multiprocessing_distributed)


def run(cfg, device, backend=None) -> int:
    """One process of the run: join the group, train, leave."""
    joined = init_distributed(cfg, device, backend).backend is not None
    try:
        from ..train.curriculum import UnimodalTrainer

        trainer = UnimodalTrainer(cfg, device)
        if cfg.runtime.show_model:
            from ..models.model_builder import count_params_flops_summary

            if trainer.rank == 0:
                print(trainer.model)
                print(count_params_flops_summary(trainer.model, cfg))
            return 0
        trainer.run()
        return 0
    finally:
        if joined:
            mesh.shutdown()


if __name__ == "__main__":
    sys.exit(main())
