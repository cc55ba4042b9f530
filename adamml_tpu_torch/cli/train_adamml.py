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


def val_labels(cfg):
    """Ground-truth labels of the val set in list order -- the row order of
    the val_*.npy artifacts written by -e."""
    import numpy as np

    from ..data.dataflow import HostDataLoader
    from ..train.curriculum import _make_dataset

    ds = _make_dataset(cfg, is_train=False, num_clips=cfg.data.val_num_clips)
    if hasattr(ds, "children"):  # MultiVideoDataset
        c = ds.children[0]
        return np.asarray([c.get_label(r) for r in ds.video_list])
    # synthetic: labels come from the per-sample rng; reproduce the loader's
    # (seed, epoch=0, index) keying
    ld = HostDataLoader(ds, 1, is_train=False, workers=1,
                        seed=cfg.runtime.seed)
    return np.asarray([ds.get_sample(i, ld._sample_rng(i))[1]
                       for i in range(len(ds))])


def run_ensemble_scoring(cfg) -> int:
    """--pred_files offline ensemble scoring (reference opts.py:123-127 --
    the reference defines but never consumes these flags; here they score
    saved eval artifacts against the val list). Host work only."""
    from ..utils.ensemble import ensemble_score

    r = cfg.runtime
    out = ensemble_score(r.pred_files, val_labels(cfg),
                         pred_weights=r.pred_weights,
                         after_softmax=r.after_softmax)
    print(f"Ensemble of {len(r.pred_files)} prediction file(s)"
          f"{' (after softmax)' if r.after_softmax else ''}:\t"
          f"Top@1: {out['top1']:.4f}\tTop@5: {out['top5']:.4f}\t"
          f"mAP: {out['mAP']:.4f}", flush=True)
    return 0


def main(argv=None, device=None) -> int:
    parser = arg_parser()
    args = parser.parse_args(argv)
    validate_args(parser, args)
    cfg = config_from_args(args)
    cfg.model.backbone_net = "adamml"
    if cfg.runtime.pred_files:
        return run_ensemble_scoring(cfg)
    init_distributed(cfg)

    from ..train.curriculum import AdaMMLTrainer

    trainer = AdaMMLTrainer(cfg, cuda_device(args) if device is None
                            else device)
    if cfg.runtime.show_model:
        from ..models.model_builder import count_params_flops_summary

        print(trainer.model)
        print(count_params_flops_summary(trainer.model, cfg))
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
