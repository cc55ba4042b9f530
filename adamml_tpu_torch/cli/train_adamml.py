"""Multi-modal AdaMML training CLI on CUDA cards (reference
train_adamml.py; ``adamml_tpu/cli/train_adamml.py``).

The JAX package's flag surface (``configs/config.py::arg_parser``); flag
values the port cannot run fail with a ValueError that names them
(README.md's port section). Runs on CUDA (``--gpu``/``--gpu_id`` pick the
device) unless ``main`` is given ``device="cpu"``. A data-parallel run has
one process per rank (parallel/mesh.py): started by hand with
``--dist-url tcp://HOST:PORT --world-size W --rank R`` (or ``--hostfile``),
or spawned one per device with ``--multiprocessing-distributed``; NCCL on
CUDA, gloo on the CPU, unless ``--dist-backend`` names one. The W ranks
form D = W / M data shards of ``--mesh_model`` M tensor-parallel ranks
each.

Usage (synthetic data; mirrors reference README.md:86-95):
  python -m adamml_tpu_torch.cli.train_adamml --dataset synthetic \
      --modality rgb sound --groups 8 --frames_per_group 4 \
      --num_segments 5 --dense_sampling --causality_modeling lstm \
      --learnable_lf_weights --cost_weights 1.0 0.05 --sync-bn ...
"""

from __future__ import annotations

import sys

from ..configs.config import (arg_parser, config_from_args, run_devices,
                              validate_args)
from ..parallel import mesh
from ..parallel.mesh import parse_hostfile  # noqa: F401  (the CLI's name)


def init_distributed(cfg, device="cpu", backend=None, timeout_s=None):
    """Join the process group the flags ask for (``--hostfile``,
    ``--dist-url --world-size --rank``; parallel/mesh.py): a no-op for one
    process."""
    return mesh.init_distributed(cfg, device, backend, timeout_s)


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
    if cfg.optim.optimizer != "sgd":
        raise ValueError(f"--optimizer {cfg.optim.optimizer} is "
                         f"train_unimodal's: train_adamml trains the main "
                         f"net with SGD and the policy with Adam")
    cfg.model.backbone_net = "adamml"
    if cfg.runtime.pred_files:
        return run_ensemble_scoring(cfg)
    return mesh.launch(run, cfg, run_devices(args, device),
                       args.dist_backend, args.multiprocessing_distributed)


def run(cfg, device, backend=None) -> int:
    """One process of the run: join the group, train or evaluate, leave."""
    joined = init_distributed(cfg, device, backend).backend is not None
    try:
        from ..train.curriculum import AdaMMLTrainer

        trainer = AdaMMLTrainer(cfg, device)
        if cfg.runtime.show_model:
            from ..models.model_builder import count_params_flops_summary

            if trainer.rank == 0:
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
    finally:
        if joined:
            mesh.shutdown()


if __name__ == "__main__":
    sys.exit(main())
