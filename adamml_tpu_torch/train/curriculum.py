"""The 3-stage AdaMML curriculum and the unimodal trainer
(``adamml_tpu/train/curriculum.py``).

Stage semantics follow reference train_adamml.py:334-626:

  warmup     (warmup_epochs): policy frozen, cost weights zeroed, base LR,
      no validation
  alternating (epochs): per epoch, one main-net pass (policy frozen, zero
      cost) then one policy pass (main frozen, configured cost), then
      validation, scheduler steps, checkpoint + selection artifacts, and
      Gumbel temperature decay x0.965
  finetune   (finetune_epochs): reload model_best, policy frozen, zero cost

Both optimizers are rebuilt over the same parameters at each stage boundary
(reference train_adamml.py:387-395,520-528), so the state of a loaded
checkpoint is replaced, not merged. Checkpoints carry temperature, stage,
epoch, best top-1, plateau state and the trainer's seed, so a restart
re-enters the right phase (reference train_adamml.py:281-312).

Where the JAX trainer carries a PRNG key and splits it once per epoch and
per validation, the port carries an integer seed that advances the same
number of times (``split_seed``); each sub-seed feeds the steps'
per-step generators (``steps.step_generators``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..ckpt.checkpoint import (CheckpointManager, load_checkpoint,
                               save_checkpoint)
from ..ckpt.pretrained import (load_pretrained_adamml,
                               load_unimodality_pretrained)
from ..configs.config import ExperimentConfig
from ..configs.dataset_config import get_dataset_config
from ..data.dataflow import HostDataLoader
from ..data.device_pipeline import (make_batch_preprocessor,
                                    make_unimodal_preprocessor)
from ..data.synthetic import SyntheticVideoDataset
from ..data.video_dataset import MultiVideoDataset
from ..models.adamml import INIT_TEMPERATURE, TEMPERATURE_DECAY
from ..models.model_builder import build_model
from ..utils.device import resolve_device
from ..utils.logging import RankZeroLogger
from .engine import train_epoch, validate
from .optim import build_optimizer
from .schedulers import ReduceLROnPlateau, lr_at_epoch
from .steps import (make_adamml_eval_step, make_adamml_train_step,
                    make_unimodal_eval_step, make_unimodal_train_step,
                    step_seed)
from .train_state import StageFlags, TrainState

Device = Optional[Union[str, torch.device]]


def split_seed(seed: int) -> Tuple[int, int]:
    """(next trainer seed, sub-seed for one epoch or validation): the
    counterpart of ``jax.random.split`` of the trainer's key."""
    a, b = np.random.RandomState(seed % 2**32).randint(0, 2**31 - 1, size=2)
    return int(a), int(b)


def _make_dataset(cfg: ExperimentConfig, *, is_train: bool, num_clips: int):
    d, m = cfg.data, cfg.model
    # --random_sampling drives non-fixed-offset val/test clip starts
    # (reference opts.py:91 -> utils/video_dataset.py fixed_offset)
    fixed_offset = not d.random_sampling
    if d.dataset == "synthetic":
        return SyntheticVideoDataset(
            modality=m.modality, length=d.synthetic_length,
            num_groups=m.groups, frames_per_group=m.frames_per_group,
            num_clips=num_clips, num_classes=m.num_classes,
            canvas_size=d.canvas_size, audio_length=d.audio_length,
            resampling_rate=d.resampling_rate, is_train=is_train,
            dense_sampling=d.dense_sampling, fixed_offset=fixed_offset,
            seed=cfg.runtime.seed + (0 if is_train else 1))
    meta = get_dataset_config(d.dataset)
    # MultiVideoDataset covers unimodal too (a one-entry modality list), so
    # every consumer sees the same {modality: payload} contract
    return MultiVideoDataset(
        d.datadir, meta.train_list_name if is_train else meta.val_list_name,
        m.modality, num_groups=m.groups,
        frames_per_group=m.frames_per_group, num_clips=num_clips,
        dense_sampling=d.dense_sampling, fixed_offset=fixed_offset,
        image_tmpl=meta.image_tmpl, is_train=is_train,
        separator=meta.filename_separator, filter_video=meta.filter_video,
        num_classes=m.num_classes, fps=d.fps, audio_length=d.audio_length,
        resampling_rate=d.resampling_rate, canvas_size=d.canvas_size,
        use_native_decoder=d.use_native_decoder,
        decode_threads=d.decode_threads)


def _make_loader(cfg: ExperimentConfig, dataset, *, is_train: bool):
    """One process: the whole batch, one shard."""
    return HostDataLoader(
        dataset, cfg.optim.batch_size, is_train=is_train,
        input_size=cfg.data.input_size, augmentor_ver=cfg.data.augmentor_ver,
        scale_range=cfg.data.scale_range,
        disable_scaleup=cfg.data.disable_scaleup,
        workers=cfg.data.workers, seed=cfg.runtime.seed,
        num_crops=cfg.data.num_crops)


def _resume_path(cfg: ExperimentConfig, log_folder: str, logger
                 ) -> Optional[str]:
    r = cfg.runtime
    if r.auto_resume and not r.resume:
        latest = CheckpointManager(log_folder).latest()
        if latest:
            logger.log("Found the checkpoint in the log folder, "
                       "will resume from there.")
            return latest
    return r.resume or None


class AdaMMLTrainer:
    """End-to-end multi-modal trainer (reference train_adamml.py:66-626),
    on ``device`` (CUDA unless the caller names another)."""

    def __init__(self, cfg: ExperimentConfig, device: Device = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model, self.arch_name = build_model(cfg, self.device)
        self.modality = cfg.model.major_modality
        self.log_folder = os.path.join(cfg.runtime.logdir or "logs",
                                       self.arch_name)
        self.rank = 0

        # data
        self.train_dataset = _make_dataset(cfg, is_train=True,
                                           num_clips=cfg.model.num_segments)
        self.val_dataset = _make_dataset(cfg, is_train=False,
                                         num_clips=cfg.data.val_num_clips)
        self.train_loader = _make_loader(cfg, self.train_dataset,
                                         is_train=True)
        self.val_loader = _make_loader(cfg, self.val_dataset, is_train=False)
        self.train_pre = make_batch_preprocessor(
            cfg, train=True, num_segments=cfg.model.num_segments,
            device=self.device)
        self.val_pre = make_batch_preprocessor(
            cfg, train=False, num_segments=cfg.data.val_num_clips,
            device=self.device)

        # optimizers, temperature, step
        self.has_policy = self.model.policy_net is not None
        self.state = TrainState(None, None, temperature=INIT_TEMPERATURE)
        self._reset_optimizers()
        # pretrained loading, unimodal graft first (reference
        # train_adamml.py:144-158 and joint_resnet_mobilenetv2.py:141-155)
        r = cfg.runtime
        if r.unimodality_pretrained:
            load_unimodality_pretrained(
                self.model, self.modality, r.unimodality_pretrained,
                depth=cfg.model.depth, fusion_point=cfg.model.fusion_point)
        if r.pretrained:
            load_pretrained_adamml(self.model, self.state, r.pretrained)
            print(f"=> using pre-trained model "
                  f"(temperature: {float(self.state.temperature)})",
                  flush=True)

        # steps
        common = dict(penalty_type=cfg.model.penalty_type,
                      gammas=cfg.model.gammas,
                      clip_gradient=cfg.optim.clip_gradient)
        self.step_main = make_adamml_train_step(
            self.model, flags=StageFlags.main_phase(), **common)
        self.step_policy = make_adamml_train_step(
            self.model, flags=StageFlags.policy_phase(), **common)
        self.eval_step = make_adamml_eval_step(
            self.model, num_crops=cfg.data.num_crops)

        self.best_top1 = 0.0
        self.curr_stage = cfg.optim.curr_stage
        self.start_epoch = cfg.optim.start_epoch
        self.seed = step_seed(cfg.runtime.seed, 17)
        self.plateau: Optional[ReduceLROnPlateau] = None
        self.p_plateau: Optional[ReduceLROnPlateau] = None
        if cfg.optim.lr_scheduler == "plateau":
            self.plateau = ReduceLROnPlateau(cfg.optim.lr)
            self.p_plateau = ReduceLROnPlateau(cfg.optim.p_lr)

    def _next_seed(self) -> int:
        self.seed, sub = split_seed(self.seed)
        return sub

    # -- lr --------------------------------------------------------------

    def _lr(self, epoch: int, base: float, plateau) -> float:
        o = self.cfg.optim
        if o.lr_scheduler == "plateau":
            return plateau.lr
        return lr_at_epoch(o.lr_scheduler, base, epoch, o.lr_steps, o.epochs)

    # -- checkpointing -----------------------------------------------------

    def _meta(self, epoch: int, stage: str) -> Dict:
        # scheduler and trainer-seed state ride in the meta so resumes
        # continue at the decayed LR / seed position (reference checkpoints
        # save p_scheduler/scheduler state dicts, train_adamml.py:373-383)
        meta = {"epoch": epoch, "arch": self.arch_name,
                "best_top1": float(self.best_top1), "stage": stage,
                "rng": self.seed}
        if self.plateau is not None:
            meta["scheduler"] = self.plateau.state_dict()
            meta["p_scheduler"] = self.p_plateau.state_dict()
        return meta

    def save(self, epoch: int, stage: str, suffix: str,
             is_best: bool = False) -> None:
        save_checkpoint(self.model, self.state, self._meta(epoch, stage),
                        self.log_folder, is_best=is_best, epoch=epoch,
                        suffix=suffix)

    def maybe_resume(self, logger) -> None:
        resume = _resume_path(self.cfg, self.log_folder, logger)
        if not resume:
            return
        meta = load_checkpoint(resume, self.model, self.state)
        self.best_top1 = meta["best_top1"]
        self.curr_stage = meta["stage"]
        self.start_epoch = meta["epoch"]
        self.seed = meta.get("rng", self.seed)
        if self.plateau is not None and "scheduler" in meta:
            self.plateau.load_state_dict(meta["scheduler"])
            self.p_plateau.load_state_dict(meta["p_scheduler"])
        logger.log(f"=> loaded checkpoint '{resume}' (epoch {meta['epoch']})")

    def _reset_optimizers(self) -> None:
        """Fresh optimizers over the same parameters (reference
        train_adamml.py:387-395): whatever state the old ones held, loaded
        from a checkpoint or not, is dropped."""
        o = self.cfg.optim
        self.state.main_opt = build_optimizer(
            "main", o, self.model.main_net.parameters())
        self.state.policy_opt = (build_optimizer(
            "policy", o, self.model.policy_net.parameters())
            if self.has_policy else None)

    # -- phases ------------------------------------------------------------

    def _train_one(self, step_fn, epoch: int, cost_weights, logger,
                   lr_epoch: Optional[int] = None):
        """lr_epoch overrides the epoch index the LR schedule sees: warmup
        passes 0 because the reference never steps its schedulers during
        warmup (train_adamml.py:340-395), so warmup runs at the base LR."""
        sub = self._next_seed()
        sched_epoch = epoch if lr_epoch is None else lr_epoch
        self.state, summary = train_epoch(
            self.train_loader, self.train_pre, step_fn, self.state,
            lr=self._lr(sched_epoch, self.cfg.optim.lr, self.plateau),
            p_lr=self._lr(sched_epoch, self.cfg.optim.p_lr, self.p_plateau),
            cost_weights=cost_weights, seed=sub, epoch=epoch,
            modality=self.modality, adamml=True,
            display=self.cfg.runtime.print_freq, rank=self.rank,
            logger=logger)
        return summary

    def _validate(self):
        return validate(self.val_loader, self.val_pre, self.eval_step,
                        self.state, seed=self._next_seed(),
                        modality=self.modality, adamml=True,
                        num_segments=self.cfg.data.val_num_clips)

    def _log_train(self, logger, epoch, total, s):
        sel = " ".join(f"{k}:{v * 100:.2f}" for k, v in s["selection"].items())
        logger.log(
            f"Train: [{epoch + 1:03d}/{total:03d}]\tLoss: {s['loss']:4.4f}\t"
            f"Top@1: {s['top1']:.4f}\tTop@5: {s['top5']:.4f}\t"
            f"Speed: {s['batch_time'] * 1000.0:.2f} ms/batch (dispatch) "
            f"{s['wall_time'] * 1000.0:.2f} ms/batch (drained)\t"
            f"Data loading: {s['data_time'] * 1000.0:.2f} ms/batch\t"
            f"Selection: {sel}")

    def _log_val(self, logger, epoch, total, v):
        sel = " ".join(f"{k}:{val * 100:.2f}"
                       for k, val in v["selection"].items())
        logger.log(
            f"Val: [{epoch + 1:03d}/{total:03d}]: \tLoss: {v['loss']:4.4f}\t"
            f"Top@1: {v['top1']:.4f}\tTop@5: {v['top5']:.4f}\t"
            f"mAP: {v['mAP']:.4f}\t"
            f"Speed: {v['batch_time'] * 1000.0:.2f} ms/batch\t"
            f"flops: {v['flops']:.2f}\tSelection: {sel}")

    def _dump_selections(self, tag: str, epoch: int, selections) -> None:
        os.makedirs(self.log_folder, exist_ok=True)
        np.savez(os.path.join(self.log_folder,
                              f"all_selection_{tag}_{epoch + 1}.npz"),
                 modality="_".join(self.modality),
                 selections=np.asarray(selections).astype(bool))

    def evaluate(self, logger=None) -> Dict:
        """-e / --evaluate path (reference train_adamml.py:203-224)."""
        v = self._validate()
        os.makedirs(self.log_folder, exist_ok=True)
        np.savez(os.path.join(self.log_folder, "all_selection.npz"),
                 modality="_".join(self.modality),
                 selections=np.asarray(v["all_selections"]).astype(bool))
        np.save(os.path.join(
            self.log_folder,
            f"val_{self.cfg.data.num_crops}crops_"
            f"{self.cfg.data.val_num_clips}clips_"
            f"{self.cfg.data.input_size}_details_.npy"), v["outputs"])
        if logger is not None:
            self._log_val(logger, 0, 1, v)
        return v

    # -- main run loop ------------------------------------------------------

    def run(self) -> Dict:
        cfg = self.cfg
        logger = RankZeroLogger(self.log_folder, rank=self.rank,
                                append=bool(cfg.runtime.resume
                                            or cfg.runtime.auto_resume))
        self.maybe_resume(logger)
        zeros = [0.0] * len(self.modality)
        cost = (cfg.model.cost_weights if cfg.model.cost_weights is not None
                else zeros)
        last_val: Dict = {}

        if self.curr_stage == "warmup":
            # no validation in warmup, as in the reference
            # (train_adamml.py:340-395): best_top1 stays 0.0, and the first
            # alternating epoch becomes model_best only if its validation
            # top-1 is above 0 (a top-1 of 0 writes no model_best)
            logger.log(f"Stage [Warming up]: Main network with "
                       f"{cfg.optim.warmup_epochs} epochs")
            for epoch in range(self.start_epoch, cfg.optim.warmup_epochs):
                s = self._train_one(self.step_main, epoch, zeros, logger,
                                    lr_epoch=0)
                self._log_train(logger, epoch, cfg.optim.warmup_epochs, s)
                self.save(epoch + 1, "warmup", "_warmup")
            self.curr_stage = "alternative_training"
            self.start_epoch = 0
            self._reset_optimizers()

        if self.curr_stage == "alternative_training":
            # the schedule applies live per epoch (lr_at_epoch's closed form
            # is torch's explicit-epoch scheduler.step(epoch+1), reference
            # train_adamml.py:460-465); see the JAX curriculum's note on the
            # reference's rebound optimizers
            logger.log(f"Stage [Alternative training]: {cfg.optim.epochs} "
                       f"epochs")
            for epoch in range(self.start_epoch, cfg.optim.epochs):
                logger.log("Stage [Alternative training]: Training Main net")
                s = self._train_one(self.step_main, epoch, zeros, logger)
                self._log_train(logger, epoch, cfg.optim.epochs, s)
                logger.log("Stage [Alternative training]: Training Policy net")
                s = self._train_one(self.step_policy, epoch, cost, logger)
                v = self._validate()
                last_val = v
                if cfg.optim.lr_scheduler == "plateau":
                    self.plateau.step(v["loss"])
                    self.p_plateau.step(v["loss"])
                self._log_train(logger, epoch, cfg.optim.epochs, s)
                self._log_val(logger, epoch, cfg.optim.epochs, v)
                self._dump_selections("main", epoch, v["all_selections"])
                is_best = v["top1"] > self.best_top1
                self.best_top1 = max(v["top1"], self.best_top1)
                self.save(epoch + 1, "alternative_training", "_main",
                          is_best=is_best)
                # temperature decay (reference train_adamml.py:516)
                self.state.temperature *= TEMPERATURE_DECAY
            self.curr_stage = "finetune"
            self.start_epoch = 0
            self._reset_optimizers()

        if self.curr_stage == "finetune":
            logger.log(f"Stage [Post finetuning]: Finetune the main network "
                       f"{cfg.optim.finetune_epochs} epochs")
            if cfg.optim.finetune_epochs > 0:
                if self.start_epoch == 0:
                    best = CheckpointManager(self.log_folder).best()
                    if best:  # reference train_adamml.py:538-551
                        # restores model_best's pre-decay temperature too
                        meta = load_checkpoint(best, self.model, self.state)
                        logger.log(f"Loaded model_best (epoch "
                                   f"{meta['epoch']}) for finetune")
                    else:
                        logger.log("Can not find the best model. "
                                   "Use the last checkpoint.")
                for epoch in range(self.start_epoch,
                                   cfg.optim.finetune_epochs):
                    s = self._train_one(self.step_main, epoch, zeros, logger)
                    v = self._validate()
                    last_val = v
                    if cfg.optim.lr_scheduler == "plateau":
                        self.plateau.step(v["loss"])
                        self.p_plateau.step(v["loss"])
                    self._log_train(logger, epoch, cfg.optim.finetune_epochs, s)
                    self._log_val(logger, epoch, cfg.optim.finetune_epochs, v)
                    self._dump_selections("finetune", epoch,
                                          v["all_selections"])
                    is_best = v["top1"] > self.best_top1
                    self.best_top1 = max(v["top1"], self.best_top1)
                    self.save(epoch + 1, "finetune", "_finetune",
                              is_best=is_best)
        logger.close()
        return last_val


class UnimodalTrainer:
    """Single-modality pretraining (reference train_unimodal.py:64-401), on
    ``device`` (CUDA unless the caller names another)."""

    def __init__(self, cfg: ExperimentConfig, device: Device = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model, self.arch_name = build_model(cfg, self.device)
        self.log_folder = os.path.join(cfg.runtime.logdir or "logs",
                                       self.arch_name)
        self.rank = 0

        self.train_dataset = _make_dataset(cfg, is_train=True,
                                           num_clips=cfg.data.num_clips)
        self.val_dataset = _make_dataset(cfg, is_train=False,
                                         num_clips=cfg.data.num_clips)
        self.train_loader = _make_loader(cfg, self.train_dataset,
                                         is_train=True)
        self.val_loader = _make_loader(cfg, self.val_dataset, is_train=False)
        self.train_pre = make_unimodal_preprocessor(
            cfg, train=True, num_clips=cfg.data.num_clips, device=self.device)
        self.val_pre = make_unimodal_preprocessor(
            cfg, train=False, num_clips=cfg.data.num_clips,
            device=self.device)

        self.state = TrainState(build_optimizer(
            "main", cfg.optim, self.model.parameters()), None)
        self.train_step = make_unimodal_train_step(
            self.model, clip_gradient=cfg.optim.clip_gradient)
        self.eval_step = make_unimodal_eval_step(
            self.model, num_crops=cfg.data.num_crops)
        self.best_top1 = 0.0
        self.start_epoch = cfg.optim.start_epoch
        self.seed = step_seed(cfg.runtime.seed, 23)
        self.plateau = (ReduceLROnPlateau(cfg.optim.lr)
                        if cfg.optim.lr_scheduler == "plateau" else None)

    def _next_seed(self) -> int:
        self.seed, sub = split_seed(self.seed)
        return sub

    def maybe_resume(self, logger) -> None:
        resume = _resume_path(self.cfg, self.log_folder, logger)
        if not resume:
            return
        meta = load_checkpoint(resume, self.model, self.state)
        self.best_top1 = meta["best_top1"]
        self.start_epoch = meta["epoch"]
        self.seed = meta.get("rng", self.seed)
        if self.plateau is not None and "scheduler" in meta:
            self.plateau.load_state_dict(meta["scheduler"])
        logger.log(f"=> loaded checkpoint '{resume}' (epoch {meta['epoch']})")

    def run(self) -> Dict:
        cfg = self.cfg
        logger = RankZeroLogger(self.log_folder, rank=self.rank,
                                append=bool(cfg.runtime.resume
                                            or cfg.runtime.auto_resume))
        self.maybe_resume(logger)
        last: Dict = {}
        for epoch in range(self.start_epoch, cfg.optim.epochs):
            lr = (self.plateau.lr if self.plateau else
                  lr_at_epoch(cfg.optim.lr_scheduler, cfg.optim.lr, epoch,
                              cfg.optim.lr_steps, cfg.optim.epochs))
            self.state, s = train_epoch(
                self.train_loader, self.train_pre, self.train_step,
                self.state, lr=lr, seed=self._next_seed(), epoch=epoch,
                adamml=False, display=cfg.runtime.print_freq, rank=self.rank,
                logger=logger)
            logger.log(
                f"Train: [{epoch + 1:03d}/{cfg.optim.epochs:03d}]\t"
                f"Loss: {s['loss']:4.4f}\tTop@1: {s['top1']:.4f}\t"
                f"Top@5: {s['top5']:.4f}\t"
                f"Speed: {s['batch_time'] * 1000.0:.2f} ms/batch (dispatch) "
                f"{s['wall_time'] * 1000.0:.2f} ms/batch (drained)\t"
                f"Data loading: {s['data_time'] * 1000.0:.2f} ms/batch")
            # lazy_eval: every 10 epochs + final 10% (reference
            # train_unimodal.py:341-346)
            do_eval = True
            if cfg.runtime.lazy_eval:
                do_eval = ((epoch + 1) % 10 == 0
                           or epoch >= int(cfg.optim.epochs * 0.9))
            is_best = False
            if do_eval:
                v = validate(self.val_loader, self.val_pre, self.eval_step,
                             self.state, seed=self._next_seed(),
                             adamml=False)
                last = v
                if self.plateau:
                    self.plateau.step(v["loss"])
                logger.log(
                    f"Val: [{epoch + 1:03d}/{cfg.optim.epochs:03d}]\t"
                    f"Loss: {v['loss']:4.4f}\tTop@1: {v['top1']:.4f}\t"
                    f"Top@5: {v['top5']:.4f}\tmAP: {v['mAP']:.4f}")
                is_best = v["top1"] > self.best_top1
                self.best_top1 = max(v["top1"], self.best_top1)
            meta = {"epoch": epoch + 1, "arch": self.arch_name,
                    "best_top1": float(self.best_top1), "stage": "unimodal",
                    "rng": self.seed}
            if self.plateau is not None:
                meta["scheduler"] = self.plateau.state_dict()
            save_checkpoint(self.model, self.state, meta, self.log_folder,
                            is_best=is_best, epoch=epoch + 1)
        logger.close()
        return last
