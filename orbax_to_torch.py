#!/usr/bin/env python3
"""Convert an orbax checkpoint of the JAX package (adamml_tpu) into a
checkpoint of the PyTorch port (adamml_tpu_torch).

    python orbax_to_torch.py SRC DST -- <the flags of train_adamml or
                                         train_unimodal>

SRC is a checkpoint directory the JAX package wrote (``checkpoint``,
``checkpoint_*_NN``, ``model_best``, of the curriculum or of a unimodal
run); DST a new directory. Run it where jax and orbax are installed: it
needs orbax and the port (torch), and nothing of the JAX package. DST holds
``state.pt`` and ``meta.json``, which the port's ``--resume``,
``--pretrained``, ``--unimodality_pretrained`` and ``-e`` take as they take
the port's own checkpoints; copy it to the card's machine.

The flags build the port's model and optimizers on the CPU, as the run
that will read DST builds them (``config_from_args``, ``build_model``,
``build_optimizer``). A tree without ``main_net`` is a unimodal run's, and
the model is its backbone, as ``train_unimodal`` builds it. What carries
over: parameters and BN statistics, the temperature and the step, the main
net's SGD momentum (FusedSGD's raveled trace or optax's per-tensor one,
the layout found from the tree), the policy net's Adam moments and count,
and the meta (epoch, stage, best top-1, the plateau schedulers; the JAX
trainer's key as a seed, ``ckpt.checkpoint.seed_from_key``). A flag set
that does not fit the tree fails on the first path that does not fit.
Prints one summary line.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional, Sequence

import orbax.checkpoint as ocp

from adamml_tpu_torch.ckpt.checkpoint import write_imported_checkpoint
from adamml_tpu_torch.ckpt.flax_convert import (flax_optimizer_state,
                                                load_flax_variables,
                                                optimizer_state_dict)
from adamml_tpu_torch.configs.config import (ExperimentConfig, arg_parser,
                                             config_from_args, validate_args)
from adamml_tpu_torch.models.model_builder import build_model
from adamml_tpu_torch.train.optim import build_optimizer


def restore_raw(path: str) -> dict:
    """The orbax tree of ``path``, restored without a target: nested dicts
    and lists of arrays."""
    return ocp.StandardCheckpointer().restore(os.path.abspath(path))


def _load_optimizer(kind: str, cfg: ExperimentConfig, module, opt_tree,
                    params_tree):
    """(port optimizer over ``module`` holding the tree's state, layout,
    tensors with state)."""
    opt = build_optimizer("main" if kind == "sgd" else "policy", cfg.optim,
                          module.parameters())
    layout, state = flax_optimizer_state(kind, opt_tree, params_tree)
    if kind == "sgd" and state and not cfg.optim.momentum:
        raise ValueError("main_opt/trace: the checkpoint holds SGD momentum, "
                         "the flags give --momentum 0")
    names = [n for n, _ in module.named_parameters()]
    opt.load_state_dict(optimizer_state_dict(opt, names, state))
    return opt, layout, len(state)


def convert(src: str, dst: str, cfg: ExperimentConfig) -> dict:
    """Write DST from SRC for the model ``cfg`` builds; returns the
    summary."""
    if os.path.exists(dst):
        raise FileExistsError(f"{dst} exists; name a new directory")
    raw = restore_raw(src)
    meta_path = os.path.join(src, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    params, stats = raw["params"], raw.get("batch_stats", {})
    unimodal = "main_net" not in params
    if unimodal:  # as cli/train_unimodal.py builds the backbone
        if len(cfg.model.modality) != 1:
            raise ValueError("a unimodal checkpoint (no main_net in its "
                             "params) takes exactly one --modality")
        if cfg.model.backbone_net == "adamml":
            cfg.model.backbone_net = ("sound_mobilenet_v2"
                                      if cfg.model.modality[0] == "sound"
                                      else "resnet")
    model, arch = build_model(cfg, device="cpu")
    load_flax_variables(model, params, stats)
    main = model if unimodal else model.main_net
    main_opt, layout, n_main = _load_optimizer(
        "sgd", cfg, main, raw.get("main_opt"),
        params if unimodal else params["main_net"])
    policy = None if unimodal else model.policy_net
    policy_opt, n_policy = None, 0
    if policy is not None:
        policy_opt, _, n_policy = _load_optimizer(
            "adam", cfg, policy, raw.get("policy_opt"), params["policy_net"])
    elif raw.get("policy_opt") is not None:
        raise ValueError("policy_opt: the checkpoint holds a policy "
                         "optimizer, the flags build no policy net")
    write_imported_checkpoint(
        dst, model.state_dict(), main_opt.state_dict(),
        None if policy_opt is None else policy_opt.state_dict(),
        raw["temperature"], raw["step"], meta, layout, src)
    leaves = len(model.state_dict())
    return {"src": os.path.abspath(src), "dst": os.path.abspath(dst),
            "arch": arch, "unimodal": unimodal, "leaves_mapped": leaves,
            "main_opt_layout": layout,
            "parameters": sum(p.numel() for p in model.parameters()),
            "main_opt_tensors": n_main, "policy_opt_tensors": n_policy,
            "step": int(raw["step"]),
            "epoch": meta.get("epoch"), "stage": meta.get("stage")}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3 or argv[2] != "--":
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    parser = arg_parser()
    args = parser.parse_args(argv[3:])
    validate_args(parser, args)
    s = convert(argv[0], argv[1], config_from_args(args))
    print(f"orbax_to_torch: {s['src']} -> {s['dst']}: {s['arch']}, "
          f"{s['leaves_mapped']} parameter and statistic leaves mapped, "
          f"{s['parameters']} parameters; main_opt layout "
          f"{s['main_opt_layout']} ({s['main_opt_tensors']} tensors with "
          f"momentum), policy_opt Adam state for {s['policy_opt_tensors']} "
          f"tensors; step {s['step']}, epoch {s['epoch']}, stage "
          f"{s['stage']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
