"""Pretrained weight loading (the port's ``adamml_tpu/ckpt/pretrained.py``).

Two of the reference's three loading modes (the third, resume, is
``ckpt/checkpoint.py``):

  --pretrained: the whole AdaMML model plus the Gumbel temperature, a
      tolerant graft by name and shape (reference train_adamml.py:144-158,
      strict=False), from a checkpoint directory of this package
  --unimodality_pretrained: one checkpoint per modality, a strict graft
      into the matching main-net backbone (reference
      models/joint_resnet_mobilenetv2.py:141-155), from a unimodal
      checkpoint directory of this package or a reference torch
      .pth/.pth.tar/.pt file (converted by ``ckpt/torch_convert.py``)

Both read full tensors; a weight sharded over --mesh_model keeps this
rank's rows of its value. An orbax checkpoint of the JAX package is refused
by name (``checkpoint.read_checkpoint``): reading one needs JAX and orbax,
which this package does not import. ``orbax_to_torch.py`` at the
repository's root converts it, where JAX is installed, into a checkpoint
directory that both modes (and resume) take.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.config import input_channels_for
from ..parallel.mesh import param_shard
from .checkpoint import read_checkpoint
from .flax_convert import flax_leaves
from .torch_convert import (convert_mobilenet_v2_state_dict,
                            convert_resnet_state_dict)

def _is_torch_file(path: str) -> bool:
    return os.path.isfile(path) and path.endswith((".pth", ".pth.tar", ".pt"))


def _torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference checkpoint's state dict as numpy arrays (the file is the
    user's own: it may pickle more than tensors, as the reference's
    ``{'state_dict': ...}`` files do)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.cpu().numpy() for k, v in sd.items()}


@torch.no_grad()
def _graft(model: nn.Module, src: Iterable[Tuple[str, torch.Tensor]],
           strict: bool, prefix: str = "") -> int:
    """Copy each (name, value) of ``src`` into ``model``'s parameter or
    buffer ``prefix + name`` when the shapes agree (a sharded weight takes
    its rows of the full value); a missing name or a shape mismatch raises
    under ``strict`` (before anything is written) and is skipped
    otherwise. Returns the number of parameters grafted (buffers are not
    counted)."""
    params = dict(model.named_parameters())
    targets = {**params, **dict(model.named_buffers())}
    plan = []
    for name, value in src:
        where = prefix + name
        tgt = targets.get(where)
        if tgt is None:
            if strict:
                raise KeyError(f"missing key in target: {where}")
            continue
        shard = param_shard(tgt)
        if shard is not None and value.shape[0] == shard.size * len(tgt):
            value = shard.rows(torch.as_tensor(value))
        if tuple(tgt.shape) != tuple(value.shape):
            if strict:
                raise ValueError(f"shape mismatch at {where}: "
                                 f"{tuple(tgt.shape)} vs {tuple(value.shape)}")
            continue
        plan.append((where, tgt, value))
    for _, tgt, value in plan:  # nothing is written unless all of src fits
        tgt.copy_(torch.as_tensor(value).to(tgt.dtype))
    return sum(where in params for where, _, _ in plan)


def load_pretrained_adamml(model: nn.Module, state, path: str) -> int:
    """Whole-model partial graft plus the temperature (reference
    train_adamml.py:144-158), in place. Returns the number of parameters
    grafted; raises when none matched."""
    _, payload = read_checkpoint(path)
    n = _graft(model, payload["model"].items(), strict=False)
    if n == 0:
        raise ValueError(f"no parameters matched in {path}")
    state.temperature = float(payload.get("temperature", state.temperature))
    return n


def _unimodal_leaves(path: str, modality: str, depth: int):
    """(name within the backbone, value) of one unimodal checkpoint."""
    if _is_torch_file(path):
        sd = _torch_state_dict(path)
        if modality == "sound":
            bp, bs = convert_mobilenet_v2_state_dict(
                sd, layout="torchvision",
                input_channels=input_channels_for(modality))
        else:
            bp, bs = convert_resnet_state_dict(
                sd, depth=depth, input_channels=input_channels_for(modality))
        out = []
        for where, name, value in flax_leaves(bp, bs):
            if name is None:
                raise KeyError(f"missing key in target: {where}")
            out.append((name, torch.from_numpy(np.ascontiguousarray(value))))
        return out
    return list(read_checkpoint(path)[1]["model"].items())


def load_unimodality_pretrained(model: nn.Module, modality: Sequence[str],
                                paths: Sequence[str], depth: int,
                                fusion_point: str = "logits") -> None:
    """Per-backbone strict graft into ``main_net.net_<modality>``, in place
    (reference joint_resnet_mobilenetv2.py:141-155)."""
    if len(paths) != len(modality):
        raise ValueError("the number of pretrained models is incorrect.")
    for m, p in zip(modality, paths):
        leaves = _unimodal_leaves(p, m, depth)
        if fusion_point != "logits":
            # fc2 fusion has no per-backbone heads; the reference pops them
            # (joint_resnet_mobilenetv2.py:148-154)
            leaves = [(k, v) for k, v in leaves
                      if not k.startswith(("fc.", "classifier."))]
        _graft(model, leaves, strict=True, prefix=f"main_net.net_{m}.")
        print(f"Loaded unimodality pretrained model for {m} from: {p}",
              flush=True)
