"""Unimodal pretraining CLI on one CUDA card (reference train_unimodal.py;
``adamml_tpu/cli/train_unimodal.py``).

Trains a single backbone (resnet for rgb/flow/rgbdiff, sound_mobilenet_v2
for sound). Mean/std overrides are validated like the reference
(train_unimodal.py:100-117). Runs on CUDA unless ``main`` is given
``device="cpu"``.

  python -m adamml_tpu_torch.cli.train_unimodal --dataset synthetic \
      --modality rgb --backbone_net resnet -d 50 --groups 8 -b 8 ...
"""

from __future__ import annotations

import sys

from ..configs.config import (arg_parser, config_from_args, cuda_device,
                              validate_args)
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
    init_distributed(cfg)

    from ..train.curriculum import UnimodalTrainer

    trainer = UnimodalTrainer(cfg, cuda_device(args) if device is None
                              else device)
    if cfg.runtime.show_model:
        print(trainer.model)
        n = sum(p.numel() for p in trainer.model.parameters())
        print(f"Total params: {n / 1e6:.2f}M")
        return 0
    trainer.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
