"""Multi-modal AdaMML training CLI on one CUDA card (reference
train_adamml.py; ``adamml_tpu/cli/train_adamml.py``).

The JAX package's flag surface (``configs/config.py::arg_parser``); flags
with no meaning on one card, or whose module is not ported yet, fail with a
ValueError that names them (README.md's port section). Runs on CUDA
(``--gpu``/``--gpu_id`` pick the device) unless ``main`` is given
``device="cpu"``.

Usage (synthetic data; mirrors reference README.md:86-95):
  python -m adamml_tpu_torch.cli.train_adamml --dataset synthetic \
      --modality rgb sound --groups 8 --frames_per_group 4 \
      --num_segments 5 --dense_sampling --causality_modeling lstm \
      --learnable_lf_weights --cost_weights 1.0 0.05 --sync-bn ...
"""

from __future__ import annotations

import sys

from ..configs.config import (arg_parser, config_from_args, cuda_device,
                              validate_args)


def parse_hostfile(lines, current_node: str):
    """Derive (coordinator_address, num_processes, process_id) from hostfile
    lines, mirroring the reference's rank derivation (reference
    train_adamml.py:40-50: line index = rank, first line's hostname = master,
    port 10598) with two hardenings: the hostname match is EXACT on the
    line's first whitespace token (the reference's `curr in node` substring
    test lets "node1" match "node10"), and an unmatched host is a loud error
    instead of a silent rank-0 fallback."""
    nodes = [x.strip() for x in lines if x.strip()]
    if not nodes:
        raise RuntimeError("hostfile is empty")
    hostnames = [n.split()[0].split(".")[0] for n in nodes]
    master = nodes[0].split()[0]
    curr = current_node.split(".")[0]
    matches = [i for i, h in enumerate(hostnames) if h == curr]
    if not matches:
        raise RuntimeError(
            f"current node {curr!r} not found in hostfile "
            f"(hosts: {hostnames}); refusing to guess a rank")
    if len(matches) > 1:
        raise RuntimeError(
            f"current node {curr!r} appears {len(matches)} times in the "
            f"hostfile; ranks would be ambiguous")
    return f"{master}:10598", len(nodes), matches[0]


def init_distributed(cfg) -> None:
    """One process on one card: a hostfile or a world size above 1 asks
    for a multi-process run, which is not ported yet (ROADMAP A.16)."""
    r = cfg.runtime
    if r.hostfile:
        raise ValueError("--hostfile: multi-process runs are not ported to "
                         "the CUDA port yet (ROADMAP A.16)")
    if r.world_size > 1:
        raise ValueError("--world-size > 1: multi-process runs are not "
                         "ported to the CUDA port yet (ROADMAP A.16)")


def main(argv=None, device=None) -> int:
    parser = arg_parser()
    args = parser.parse_args(argv)
    validate_args(parser, args)
    cfg = config_from_args(args)
    cfg.model.backbone_net = "adamml"
    init_distributed(cfg)

    from ..train.curriculum import AdaMMLTrainer

    trainer = AdaMMLTrainer(cfg, cuda_device(args) if device is None
                            else device)
    if cfg.runtime.show_model:
        print(trainer.model)
        n = sum(p.numel() for p in trainer.model.parameters())
        print(f"Total params: {n / 1e6:.2f}M")
        return 0
    if cfg.runtime.evaluate:
        from ..utils.logging import RankZeroLogger

        logger = RankZeroLogger(trainer.log_folder, rank=trainer.rank,
                                filename="evaluate_log.log", append=True)
        trainer.evaluate(logger)
        logger.close()
        return 0
    trainer.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
