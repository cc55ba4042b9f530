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

The optimizer state goes the same way (``flax_optimizer_state``, then
``optimizer_state_dict``): each per-parameter leaf takes its parameter's
name and layout. The JAX package keeps it in one of two layouts, found from
the tree:

    "fused"       main_opt {"trace": one vector}: FusedSGD's momentum over
                  jax.flatten_util.ravel_pytree(params["main_net"]), split
                  by ``unravel_like``
    "per_tensor"  main_opt [..., {"trace": params-shaped tree}, ...]: optax

and the policy's optax Adam is per-tensor in both ([..., {"count", "mu",
"nu"}, ...]). An optax state is found by its keys, not by its place in the
chain, whose length depends on the weight decay; momentum 0 leaves no
"trace", rng_policy no policy state. SGD's trace becomes
``momentum_buffer`` (both with dampening 0: a zero trace and a fresh
buffer give the gradient on the next step), Adam's count every
parameter's float32 ``step`` and mu / nu ``exp_avg`` / ``exp_avg_sq``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

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


# --------------------------------------------------------------------------
# optimizer state
# --------------------------------------------------------------------------

_OPT_KEYS = {"sgd": ("trace",), "adam": ("count", "mu", "nu")}

# {port parameter name: (flax path, {state key: value in the port's layout})}
OptState = Dict[str, Tuple[str, Dict[str, np.ndarray]]]


def _ravel_order(tree: Mapping, prefix=()) -> Iterator[Tuple[tuple, object]]:
    """(path, leaf) in jax's flatten order: depth first, dict keys sorted
    (whatever order the dicts were built in)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _ravel_order(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def unravel_like(flat, params_tree: Mapping) -> Dict:
    """``flat``, a vector that ``jax.flatten_util.ravel_pytree`` made of
    ``params_tree``, split into one array per leaf: a nested dict with the
    tree's paths and shapes."""
    flat = np.asarray(flat)
    leaves = list(_ravel_order(params_tree))
    total = sum(int(np.size(v)) for _, v in leaves)
    if flat.ndim != 1 or flat.size != total:
        raise ValueError(f"a raveled vector of shape {flat.shape} against "
                         f"{total} parameters in {len(leaves)} tensors")
    out: Dict = {}
    at = 0
    for path, v in leaves:
        shape = np.shape(v)
        n = int(np.prod(shape))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[at:at + n].reshape(shape)
        at += n
    return out


def _find_states(tree, keys: Sequence[str]) -> List[Mapping]:
    """Every mapping in ``tree`` (dicts, lists and None, as orbax restores
    an optax chain) that holds all of ``keys``, outermost only."""
    if isinstance(tree, Mapping):
        if set(keys) <= set(tree):
            return [tree]
        return [s for v in tree.values() for s in _find_states(v, keys)]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _find_states(v, keys)]
    return []


def _params_shaped(value, params_tree: Mapping, where: str
                   ) -> Dict[str, Tuple[str, np.ndarray]]:
    """{port name: (flax path, value in the port's layout)} of one
    params-shaped state: a tree, or a raveled vector (``unravel_like``)."""
    if not isinstance(value, Mapping):
        try:
            value = unravel_like(value, params_tree)
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from None
    out = {}
    for path, name, v in flax_leaves(value, {}):
        if name is None:
            raise ValueError(f"{where}/{path}: a leaf of no parameter")
        out[name] = (f"{where}/{path}", v)
    return out


def flax_optimizer_state(kind: str, opt_tree, params_tree: Mapping
                         ) -> Tuple[Optional[str], OptState]:
    """(layout, state) of one optimizer of a restored JAX checkpoint:
    ``kind`` "sgd" (main_opt) or "adam" (policy_opt) over the parameter
    subtree ``params_tree``. The layout is "fused" (a raveled SGD trace),
    "per_tensor" (a params-shaped one; the policy's Adam always) or None
    (no state: momentum 0, no policy optimizer)."""
    where = "main_opt" if kind == "sgd" else "policy_opt"
    found = _find_states(opt_tree, _OPT_KEYS[kind])
    if not found:
        return None, {}
    if len(found) > 1:
        raise ValueError(f"{where}: {len(found)} {kind} states in the tree")
    st = found[0]
    if kind == "sgd":
        trace = st["trace"]
        layout = "per_tensor" if isinstance(trace, Mapping) else "fused"
        return layout, {
            name: (path, {"momentum_buffer": v}) for name, (path, v) in
            _params_shaped(trace, params_tree, f"{where}/trace").items()}
    mu = _params_shaped(st["mu"], params_tree, f"{where}/mu")
    nu = _params_shaped(st["nu"], params_tree, f"{where}/nu")
    if set(mu) != set(nu):
        raise ValueError(f"{where}: mu and nu differ in "
                         f"{sorted(set(mu) ^ set(nu))}")
    step = np.asarray(st["count"], np.float32).reshape(())
    return "per_tensor", {
        name: (path, {"step": step, "exp_avg": v, "exp_avg_sq": nu[name][1]})
        for name, (path, v) in mu.items()}


def optimizer_state_dict(opt: torch.optim.Optimizer, names: Sequence[str],
                         state: OptState) -> dict:
    """``opt.state_dict()`` holding ``state`` (``flax_optimizer_state``):
    ``names[i]`` is the name of the optimizer's i-th parameter, in the
    tree's naming. Fails by name on state left over, on a parameter left
    without state when the tree has some, and on a shape that does not
    fit."""
    params = [p for g in opt.param_groups for p in g["params"]]
    left = sorted(path for name, (path, _) in state.items()
                  if name not in names)
    if left:
        raise ValueError(f"optimizer state left over: {left}")
    missing = [n for n in names if n not in state]
    if state and missing:
        raise ValueError(f"port parameters left without optimizer state: "
                         f"{missing}")
    sd = opt.state_dict()
    sd["state"] = {}
    for i, (name, p) in enumerate(zip(names, params)):
        if name not in state:
            continue
        path, entry = state[name]
        out = {}
        for k, v in entry.items():
            if k != "step" and tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{path}: does not fit {name} "
                                 f"{tuple(p.shape)} (port layout {v.shape})")
            out[k] = torch.tensor(np.ascontiguousarray(v),
                                  dtype=torch.float32)
        sd["state"][i] = out
    return sd
