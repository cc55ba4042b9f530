"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Flax variables are shaped by ``jax.eval_shape`` of the module's init (no
compile, no run) and filled from a numpy RandomState, so both frameworks get
the same weights without paying for flax's eager init. BN statistics and
affine parameters are random too, so the eval-mode normalize is not the
identity.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Import into a test module to run its torch work on one thread: the
    parity tests' tensors are small, and the tier-1 run's workers share the
    machine's cores, where each worker's own thread pool would only contend
    with the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_variables(module, rs: np.random.RandomState, *args, **kwargs):
    """{'params', 'batch_stats'} of ``module`` as nested dicts of numpy
    arrays drawn from ``rs``."""
    rngs = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: module.init(rngs, *args, **kwargs))

    def fill(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            v = rs.randn(*shape) / math.sqrt(math.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = rs.uniform(0.5, 1.5, shape)
        elif name == "lf_weights":
            v = rs.uniform(0.2, 0.6, shape)
        else:  # bias, mean
            v = rs.randn(*shape) * 0.1
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree_util.tree_map(np.asarray, tree)


def zero_noise_jax(rng, logits, tau):
    """gumbel_decision with zero noise: hard argmax, decision = column 1."""
    return (jnp.argmax(logits, -1) == 1).astype(jnp.float32)


def zero_noise_torch(generator, logits, tau):
    return (logits.argmax(-1) == 1).float()


def st_zero_noise_jax(rng, logits, tau):
    """gumbel_decision with zero noise and the straight-through gradient
    (tests/test_parity_training.py:52-55): forward the hard argmax, backward
    the softmax's."""
    y = jax.nn.softmax(logits / tau, axis=-1)
    hard = (jnp.argmax(logits, axis=-1) == 1).astype(jnp.float32)
    return hard + y[..., 1] - jax.lax.stop_gradient(y[..., 1])


def st_zero_noise_torch(generator, logits, tau):
    y = torch.softmax(logits / tau, dim=-1)
    hard = (logits.argmax(-1) == 1).float()
    return hard + y[..., 1] - y[..., 1].detach()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))
