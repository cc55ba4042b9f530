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

each holding ``state.pt`` and ``meta.json``. The meta carries
``optim_layout: "torch"``; ``check_layout`` refuses any other tag, so an
orbax checkpoint of the JAX package (tag "fused" or "per_tensor") is named
as such instead of failing inside ``torch.load``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Tuple

import torch
from torch import nn

from ..train.train_state import TrainState

_META = "meta.json"
_STATE = "state.pt"
LAYOUT = "torch"


def save_checkpoint(model: nn.Module, state: TrainState, meta: dict,
                    filepath: str, is_best: bool = False,
                    epoch: Optional[int] = None, suffix: str = "") -> str:
    """Write the latest checkpoint (+ per-epoch / model_best copies) and
    return its path."""
    path = os.path.abspath(os.path.join(filepath, "checkpoint"))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    payload = {"model": model.state_dict(),
               "main_opt": state.main_opt.state_dict(),
               "temperature": float(state.temperature),
               "step": int(state.step)}
    if state.policy_opt is not None:
        payload["policy_opt"] = state.policy_opt.state_dict()
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
    return path


def peek_meta(path: str) -> dict:
    """A checkpoint's host metadata, without loading its tensors."""
    with open(os.path.join(os.path.abspath(path), _META)) as f:
        return json.load(f)


def check_layout(meta: dict, path: str) -> None:
    saved = meta.get("optim_layout")
    if saved != LAYOUT:
        origin = ("an orbax checkpoint of the JAX package (adamml_tpu); "
                  "reading it needs jax and orbax, so it waits for the "
                  "orbax import tool (ROADMAP A.19), which is not part of "
                  "this package"
                  if saved in ("fused", "per_tensor")
                  else "not a checkpoint of this package")
        raise RuntimeError(f"checkpoint {path!r} has layout {saved!r}, "
                           f"{origin}; this package reads layout "
                           f"{LAYOUT!r} only")


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
    (tensors land on the model's device) and return the meta."""
    meta, payload = read_checkpoint(path, next(model.parameters()).device)
    model.load_state_dict(payload["model"])
    state.main_opt.load_state_dict(payload["main_opt"])
    if state.policy_opt is not None and "policy_opt" in payload:
        state.policy_opt.load_state_dict(payload["policy_opt"])
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
