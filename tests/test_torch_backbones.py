"""PyTorch port: GroupedBatchNorm (eval), ResNetTSN and both MobileNetV2
variants against the JAX package, weights carried by load_flax_variables
(eval mode; train mode is tests/test_torch_train.py).

Float32 on both sides; tolerance 1e-4 absolute on outputs of order 1
(float32 convolution sums in another order). The JAX side runs on the CPU
mesh of conftest.py, where the fused epilogue op takes its reference_impl.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adamml_tpu.models.mobilenet_v2 import MobileNetV2 as JMobileNetV2
from adamml_tpu.models.norm import GroupedBatchNorm as JBN
from adamml_tpu.models.resnet_tsn import ResNetTSN as JResNetTSN
from adamml_tpu_torch.ckpt.flax_convert import load_flax_variables
from adamml_tpu_torch.models import resnet_tsn as tresnet
from adamml_tpu_torch.models.model_builder import init_model
from adamml_tpu_torch.models.mobilenet_v2 import MobileNetV2
from adamml_tpu_torch.models.norm import GroupedBatchNorm
from adamml_tpu_torch.models.resnet_tsn import ResNetTSN

from torch_parity import flax_variables, one_torch_thread, t  # noqa: F401

TOL = 1e-4


def _run_pair(jmod, tmod, x, rs, **kw):
    """(JAX output, port output) of one module on x, same weights."""
    v = flax_variables(jmod, rs, jnp.asarray(x), train=False, **kw)
    load_flax_variables(tmod, v["params"], v.get("batch_stats", {}))
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False, **kw))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(t(x), train=False, **kw)
    return want, got


@pytest.mark.parametrize("return_affine", [False, True])
def test_grouped_batchnorm_eval(return_affine):
    rs = np.random.RandomState(0)
    x = rs.randn(6, 3, 3, 16).astype(np.float32)
    jmod = JBN(use_running_average=True, return_affine=return_affine)
    v = flax_variables(jmod, rs, jnp.asarray(x))
    want = jmod.apply(v, jnp.asarray(x))
    bn = load_flax_variables(GroupedBatchNorm(16), v["params"],
                             v["batch_stats"])
    with torch.no_grad():
        got = bn(t(x), train=False, return_affine=return_affine)
    if return_affine:
        for g, w in zip(got, want):
            assert tuple(g.shape) == (1, 1, 16)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # eval mode reads the running statistics and leaves them as they are
    # (train mode, which moves them: tests/test_torch_train.py)
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  v["batch_stats"]["var"])


# (depth, frames, segments, fused): F=4 pools twice, F=8 three times
RESNET_CASES = [(18, 4, 2, True), (18, 4, 2, False), (50, 8, 2, True),
                (18, 3, 1, True)]


@pytest.fixture(scope="module", params=RESNET_CASES,
                ids=[f"r{d}-F{f}-S{s}-{'fused' if fu else 'plain'}"
                     for d, f, s, fu in RESNET_CASES])
def resnet_pair(request):
    depth, f, s, fused = request.param
    rs = np.random.RandomState(depth + f)
    x = rs.randn(2 * s, f, 32, 32, 3).astype(np.float32)
    jmod = JResNetTSN(depth=depth, num_classes=5, dtype=jnp.float32,
                      bn_seq_groups=s, fused_tpool=fused)
    tmod = ResNetTSN(depth=depth, num_classes=5, fused_tpool=fused)
    v = flax_variables(jmod, rs, jnp.asarray(x), train=False)
    load_flax_variables(tmod, v["params"], v["batch_stats"])
    out = {}
    for features in (False, True):
        out[features] = np.asarray(jax.jit(
            lambda v, x, features=features: jmod.apply(
                v, x, train=False, features=features))(v, jnp.asarray(x)))
    return request.param, x, tmod, out


def test_resnet_logits(resnet_pair, monkeypatch):
    """Logits match; the fused path calls the epilogue op once per pooled
    stage boundary (stages 1-3 while more than one frame is left)."""
    (depth, f, s, fused), x, tmod, out = resnet_pair
    calls = []
    real = tresnet.fused_bn_add_relu_tpool
    monkeypatch.setattr(tresnet, "fused_bn_add_relu_tpool",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    with torch.no_grad():
        got = tmod(t(x), seq_groups=s)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2 * s, 5)
    np.testing.assert_allclose(got.numpy(), out[False], atol=TOL, rtol=TOL)
    pools = {8: 3, 4: 2, 3: 2}[f]
    assert len(calls) == (pools if fused else 0)


def test_resnet_features(resnet_pair):
    (depth, f, s, fused), x, tmod, out = resnet_pair
    with torch.no_grad():
        got = tmod(t(x), features=True, seq_groups=s)
    assert tuple(got.shape) == out[True].shape
    np.testing.assert_allclose(got.numpy(), out[True], atol=TOL, rtol=TOL)


def test_resnet_gate_skips_split_segments(monkeypatch):
    """Rows that do not split into whole segment cycles take the plain
    composition, as in the JAX gate (resnet_tsn.py:235-239)."""
    calls = []
    monkeypatch.setattr(tresnet, "fused_bn_add_relu_tpool",
                        lambda *a: calls.append(1))
    tmod = init_model(ResNetTSN(depth=18, num_classes=5))
    with torch.no_grad():
        tmod(torch.randn(3, 2, 16, 16, 3), seq_groups=2)
    assert calls == []


MNV2_CASES = [
    # (name, module kwargs, input shape, features)
    ("audio", dict(num_classes=5), (2, 1, 256, 32, 1), False),
    ("policy_rgb", dict(temporal_pooling=True), (3, 2, 24, 24, 3), True),
    ("policy_sound", dict(temporal_pooling=True), (2, 1, 64, 32, 1), True),
]


@pytest.mark.parametrize("name,kw,shape,features", MNV2_CASES,
                         ids=[c[0] for c in MNV2_CASES])
def test_mobilenet_v2(name, kw, shape, features):
    rs = np.random.RandomState(len(name))
    x = rs.randn(*shape).astype(np.float32)
    jmod = JMobileNetV2(dtype=jnp.float32, **kw)
    tmod = MobileNetV2(input_channels=shape[-1], head=not features, **kw)
    want, got = _run_pair(jmod, tmod, x, rs, features=features)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
