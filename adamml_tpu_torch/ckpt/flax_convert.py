"""Carry the JAX package's weights into the port.

``load_flax_variables(model, params, batch_stats)`` takes ``{params,
batch_stats}`` as nested dicts of numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, variables)``) and fills the port's
modules, whose names follow the flax tree path for path:

    conv kernel (kh, kw, I, O)     -> weight (O, I, kh, kw)
    depthwise kernel (3, 3, 1, C)  -> weight (C, 1, 3, 3)
    Dense kernel (I, O)            -> weight (O, I); bias as is
    BN scale / bias / mean / var   -> weight / bias / running_mean / running_var
    main_net/lf_weights            -> main_net.lf_weights

The LSTM cell is a flax ``nn.scan`` with broadcast params, so its ih, hh and
fc_<m> kernels are not stacked and map like any Dense. Fails on any key
left unused and on any port parameter or buffer left unfilled.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
               "lf_weights": "lf_weights"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _to_torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)  # (kh, kw, I, O) -> (O, I, kh, kw)
    if leaf == "kernel" and value.ndim == 2:
        return value.T                       # (I, O) -> (O, I)
    return value


def flax_leaves(params: Mapping, batch_stats: Mapping
                ) -> Iterator[Tuple[str, Optional[str], np.ndarray]]:
    """(flax path, port state-dict name or None for a leaf this mapping
    does not know, value in the port's layout) for every leaf of
    ``{params, batch_stats}``."""
    for tree, leaf_map in ((params, _PARAM_LEAF), (batch_stats, _STAT_LEAF)):
        for path, value in _flatten(tree).items():
            leaf = path[-1]
            name = (".".join(path[:-1] + (leaf_map[leaf],))
                    if leaf in leaf_map else None)
            yield "/".join(path), name, _to_torch_layout(leaf, value)


@torch.no_grad()
def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping) -> nn.Module:
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    filled = set()
    unused = []
    for path, name, v in flax_leaves(params, batch_stats):
        if name not in targets:
            unused.append(path)
            continue
        t = targets[name]
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{path}: does not fit {name} {tuple(t.shape)} "
                             f"(port layout {v.shape})")
        if name in filled:
            raise ValueError(f"{name} filled twice")
        t.copy_(torch.tensor(np.ascontiguousarray(v), dtype=t.dtype))
        filled.add(name)
    if unused:
        raise ValueError(f"flax keys left unused: {sorted(unused)}")
    missing = sorted(set(targets) - filled)
    if missing:
        raise ValueError(f"port parameters left unfilled: {missing}")
    return model
