"""Checkpoints (``adamml_tpu/ckpt/checkpoint.py``), with ``torch.save``.

A checkpoint persists what the reference persists (reference
train_adamml.py:373-383): the model's state dict (parameters and BN
statistics), both optimizers' state dicts, the Gumbel temperature and the
step counter, plus host metadata {epoch, stage, best_top1, arch, ...} as
JSON. The directory layout is the JAX package's (reference
utils/utils.py:89-96):

  <dir>/checkpoint            -- always-overwritten latest
  <dir>/checkpoint<sfx>_NN    -- per-epoch copy when epoch is given
  <dir>/model_best            -- copy on val-top-1 improvement

each holding ``state.pt`` and ``meta.json``. Rank 0 writes them;
``load_checkpoint`` runs on every rank, onto its own device. A checkpoint
is unsharded: at --mesh_model M > 1 every rank gathers each sharded weight
and its optimizer state over its model group before rank 0 writes, and on
load every rank reads the full tensors and keeps its rows, so one written
at any M resumes at any other. The meta carries
``optim_layout: "torch"``; ``check_layout`` refuses any other tag, so an
orbax checkpoint of the JAX package (tag "fused" or "per_tensor", or no tag
beside orbax's own files) is named as such instead of failing inside
``torch.load``. This package does not read orbax: ``orbax_to_torch.py`` at
the repository's root, run where jax and orbax are installed, converts such
a checkpoint into one of this layout (``write_imported_checkpoint``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import (barrier, full_optimizer_state, full_state_dict,
                             shard_optimizer_state, shard_state_dict)
from ..train.train_state import TrainState

_META = "meta.json"
_STATE = "state.pt"
LAYOUT = "torch"
# files orbax writes into a checkpoint directory (one is enough)
_ORBAX_FILES = ("_CHECKPOINT_METADATA", "manifest.ocdbt")


def save_checkpoint(model: nn.Module, state: TrainState, meta: dict,
                    filepath: str, is_best: bool = False,
                    epoch: Optional[int] = None, suffix: str = "",
                    rank: int = 0) -> str:
    """Write the latest checkpoint (+ per-epoch / model_best copies) and
    return its path. In a data-parallel run every rank calls it and rank 0
    writes, then all wait for it (a barrier, as the reference's rank-0 save
    and dist.barrier, reference train_adamml.py:355,471,583), so no rank
    reads a checkpoint before it exists."""
    path = os.path.abspath(os.path.join(filepath, "checkpoint"))
    payload = {"model": full_state_dict(model),
               "main_opt": full_optimizer_state(state.main_opt),
               "temperature": float(state.temperature),
               "step": int(state.step)}
    if state.policy_opt is not None:
        payload["policy_opt"] = full_optimizer_state(state.policy_opt)
    if rank == 0:
        _write(payload, meta, filepath, path, is_best, epoch, suffix)
    barrier()
    return path


def _write(payload, meta, filepath, path, is_best, epoch, suffix):
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(payload, os.path.join(path, _STATE))
    with open(os.path.join(path, _META), "w") as f:
        json.dump({**meta, "optim_layout": LAYOUT}, f)
    copies = ([f"checkpoint{suffix}_{epoch:02d}"] if epoch is not None
              else []) + (["model_best"] if is_best else [])
    for name in copies:
        dst = os.path.join(filepath, name)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(path, dst)


def peek_meta(path: str) -> dict:
    """A checkpoint's host metadata, without loading its tensors."""
    with open(os.path.join(os.path.abspath(path), _META)) as f:
        return json.load(f)


def _is_orbax(meta: dict, path: str) -> bool:
    return (meta.get("optim_layout") in ("fused", "per_tensor")
            or any(os.path.exists(os.path.join(path, f))
                   for f in _ORBAX_FILES))


def check_layout(meta: dict, path: str) -> None:
    saved = meta.get("optim_layout")
    if saved != LAYOUT:
        origin = ("an orbax checkpoint of the JAX package (adamml_tpu), "
                  "refused by the package; convert it with python "
                  "orbax_to_torch.py SRC DST -- <the run's flags>, where "
                  "jax and orbax are installed"
                  if _is_orbax(meta, path)
                  else "not a checkpoint of this package")
        raise RuntimeError(f"checkpoint {path!r} has layout {saved!r}, "
                           f"{origin}; this package reads layout "
                           f"{LAYOUT!r} only")


def seed_from_key(key) -> int:
    """The trainer seed of an imported checkpoint: the words of the JAX
    trainer's uint32 key (the meta's ``rng`` list), high word first, as
    one integer mod 2**63. The two packages draw different streams from
    their states anyway; the seed only keeps an imported run's noise
    fixed from its start."""
    seed = 0
    for w in np.asarray(key, np.uint64).ravel():
        seed = ((seed << 32) | int(w)) % 2 ** 63
    return seed


def write_imported_checkpoint(path: str, model_state: dict, main_opt: dict,
                              policy_opt: Optional[dict], temperature: float,
                              step: int, jax_meta: dict, layout: Optional[str],
                              source: str) -> str:
    """Write the checkpoint directory ``path`` (``state.pt`` and
    ``meta.json``, as ``save_checkpoint`` writes them) from tensors already
    in this package's layout: the state dicts of the model and of both
    optimizers, the temperature and the step. The meta is the JAX one with
    ``optim_layout`` "torch", ``imported_from`` (the JAX layout and the
    source path) and ``rng`` as ``seed_from_key`` of the JAX key; the
    plateau schedulers' state dicts carry over as they are (the same
    keys)."""
    path = os.path.abspath(path)
    payload = {"model": model_state, "main_opt": main_opt,
               "temperature": float(temperature), "step": int(step)}
    if policy_opt is not None:
        payload["policy_opt"] = policy_opt
    meta = {**jax_meta, "imported_from": {"layout": layout,
                                          "path": os.path.abspath(source)}}
    if "rng" in meta:
        meta["rng"] = seed_from_key(meta["rng"])
    _write(payload, meta, os.path.dirname(path), path, False, None, "")
    return path


def read_checkpoint(path: str, map_location="cpu") -> Tuple[dict, dict]:
    """(meta, tensors) of a checkpoint directory, its layout checked
    first."""
    path = os.path.abspath(path)
    meta = peek_meta(path)
    check_layout(meta, path)
    return meta, torch.load(os.path.join(path, _STATE),
                            map_location=map_location, weights_only=True)


def load_checkpoint(path: str, model: nn.Module, state: TrainState) -> dict:
    """Restore the model, both optimizers, temperature and step in place
    (tensors land on the model's device; sharded weights and their
    optimizer state keep this rank's rows) and return the meta."""
    meta, payload = read_checkpoint(path, next(model.parameters()).device)
    model.load_state_dict(shard_state_dict(model, payload["model"]))
    state.main_opt.load_state_dict(
        shard_optimizer_state(state.main_opt, payload["main_opt"]))
    if state.policy_opt is not None and "policy_opt" in payload:
        state.policy_opt.load_state_dict(
            shard_optimizer_state(state.policy_opt, payload["policy_opt"]))
    state.temperature = payload["temperature"]
    state.step = payload["step"]
    return meta


class CheckpointManager:
    """Auto-resume helper (reference train_adamml.py:275-312)."""

    def __init__(self, log_folder: str) -> None:
        self.log_folder = log_folder

    def latest(self) -> Optional[str]:
        p = os.path.join(self.log_folder, "checkpoint")
        return p if os.path.exists(os.path.join(p, _META)) else None

    def best(self) -> Optional[str]:
        p = os.path.join(self.log_folder, "model_best")
        return p if os.path.exists(os.path.join(p, _META)) else None
