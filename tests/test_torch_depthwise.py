"""PyTorch port, the opt-in depthwise path (``use_pallas_dw=True``) and the
kernel tools' stage-boundary prototype, against the JAX package:

  (a) the depthwise ``reference_impl`` against ``_pallas_dw`` (Pallas
      interpret mode) and ``_xla_dw``;
  (b) ``depthwise_conv3x3``'s forward and gradients against the JAX custom
      VJP;
  (c) ``MobileNetV2(use_pallas_dw=True)`` against flax, the audio model and
      the policy trunk, eval and train mode;
  (d) a guard: the flag changes the JAX function (SAME padding at stride 2
      is (0, 1) where ``nn.Conv`` pads (1, 1)), so (c) would catch a port
      that reused the symmetric convolution;
  (e) the tiny flagship with the flag: forward and eval step (its train
      steps are tests/test_torch_depthwise_train.py);
  (f) ``tpool_proto.reference_impl`` against ``tpool_pallas`` (interpret
      mode) and the eager ``tpool_rw`` of tools/bench_tpool.py.

The Pallas kernels run in interpret mode through pytest's monkeypatch: the
depthwise module's ``pl`` becomes a namespace whose ``pallas_call`` passes
``interpret=True``; tools/bench_tpool.py, loaded by path, imports pallas
inside ``tpool_pallas``, so there ``pallas_call`` itself is patched for the
test. Nothing in the JAX package changes. Float32 unless stated; each
tolerance sits beside its comparison. The CUDA kernels are held against
these plain versions on a card (tests/test_torch_gpu.py).
"""

import functools
import importlib
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from adamml_tpu.models.mobilenet_v2 import MobileNetV2 as JMobileNetV2
from adamml_tpu.ops.pallas import depthwise as jdw
from adamml_tpu_torch.ckpt.flax_convert import load_flax_variables
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.models.mobilenet_v2 import MobileNetV2
from adamml_tpu_torch.ops.kernels import build
from adamml_tpu_torch.ops.kernels import depthwise as tdw
from adamml_tpu_torch.ops.kernels import tpool_proto as tpp
from adamml_tpu_torch.ops.temporal import temporal_pool
from adamml_tpu_torch.train import steps as tsteps
from adamml_tpu_torch.train.train_state import EvalState

from torch_parity import (flax_variables, one_torch_thread, t,  # noqa: F401
                          zero_noise_torch)
from test_torch_adamml import make_bundle

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def interpret_dw(monkeypatch):
    monkeypatch.setattr(jdw, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))


def _dw_args(rs, shape, affine=True):
    """x, taps (3, 3, C), scale, bias; x scaled so ReLU6 clips at both
    ends."""
    c = shape[-1]
    x = (rs.randn(*shape) * 2.0).astype(np.float32)
    w = rs.randn(3, 3, c).astype(np.float32)
    if affine:
        scale = (rs.randn(c) * 0.3 + 1.0).astype(np.float32)
        bias = (rs.randn(c) * 0.5).astype(np.float32)
    else:
        scale, bias = np.ones(c, np.float32), np.zeros(c, np.float32)
    return x, w, scale, bias


def test_same_pads_match_jax():
    """(out, lo, hi) equals ``_same_pads`` with ``_pallas_dw``'s high-side
    extension, and stride 2 on an even size pads (0, 1)."""
    for size in range(1, 14):
        for stride in (1, 2):
            out, lo, hi = jdw._same_pads(size, stride)
            hi = max(hi, (out - 1) * stride + 3 - size - lo)
            assert tdw.same_pads(size, stride) == (out, lo, hi)
    assert tdw.same_pads(8, 2) == (4, 0, 1)
    assert tdw.same_pads(9, 2) == (5, 1, 1)
    assert tdw.same_pads(8, 1) == (8, 1, 1)


DW_SIZES = [(8, 8), (9, 11), (6, 6)]


# (affine, taps): the identity as ones and zeros, an affine, the identity
# as no scale and no bias (the kernel's null pointers; JAX gets ones and
# zeros), and bf16 taps
DW_MODES = [(False, "f32"), (True, "f32"), (None, "f32"), (None, "bf16"),
            (True, "bf16")]


@pytest.mark.parametrize("affine", DW_MODES,
                         ids=["identity", "affine", "none", "none_taps_bf16",
                              "affine_taps_bf16"])
@pytest.mark.parametrize("relu6", [False, True], ids=["linear", "relu6"])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
@pytest.mark.parametrize("hw", DW_SIZES, ids=[f"{h}x{w}" for h, w in DW_SIZES])
def test_reference_impl_matches_pallas(hw, stride, relu6, affine,
                                       interpret_dw):
    """(a) within 1e-5: float32 sums of nine products, which XLA may
    contract into multiply-adds. bf16 taps reach both versions as bf16."""
    affine, taps = affine
    h, w_ = hw
    rs = np.random.RandomState(h * 10 + w_ + stride)
    x, w, scale, bias = _dw_args(rs, (2, h, w_, 16), bool(affine))
    tw = t(w) if taps == "f32" else t(w).to(torch.bfloat16)
    got = tdw.reference_impl(
        t(x), tw, None if affine is None else t(scale),
        None if affine is None else t(bias), stride, relu6).numpy()
    assert got.shape == (2, -(-h // stride), -(-w_ // stride), 16)
    jw = jnp.asarray(w) if taps == "f32" else jnp.asarray(w).astype(
        jnp.bfloat16)
    for name, fn in (("_pallas_dw", jdw._pallas_dw), ("_xla_dw", jdw._xla_dw)):
        # XLA's convolution takes one dtype: the bf16 taps exactly in f32
        jargs = [jnp.asarray(x), jw if name == "_pallas_dw" else
                 jw.astype(jnp.float32), jnp.asarray(scale),
                 jnp.asarray(bias)]
        want = np.asarray(fn(*jargs, stride, relu6))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def _loss_torch(out):
    return (out * torch.cos(out.float())).sum()


def _loss_jax(out):
    # tests/test_pallas.py:58-68
    return jnp.sum(out * jnp.cos(out.astype(jnp.float32)))


# (affine, JAX route, dtype): JAX's own CPU route (XLA), then its Pallas
# kernel in interpret mode with the TPU gate opened, where the stride-1
# input gradient is the kernel with flipped taps, in float32 and in bf16
# (x and taps)
VJP_CASES = [(False, "xla", "float32"), (True, "xla", "float32"),
             (False, "pallas", "float32"), (True, "pallas", "float32"),
             (False, "pallas", "bfloat16")]


@pytest.mark.parametrize("affine", VJP_CASES,
                         ids=["identity", "affine", "identity_pallas",
                              "affine_pallas", "identity_pallas_bf16"])
@pytest.mark.parametrize("relu6", [False, True], ids=["linear", "relu6"])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
def test_depthwise_conv3x3_grads_match_jax(stride, relu6, affine, request,
                                           monkeypatch):
    """(b) float32: forward within 1e-5; each gradient within 1e-4 of its
    largest entry (float32 convolutions of the cotangent summed in another
    order). bf16: the forward within one bf16 ulp (XLA may contract a
    multiply-add, which can move a rounding by one ulp) and each gradient
    within 2^-7 of its largest entry (one bf16 rounding of float32 sums
    taken in another order). 7x10 is odd in H and even in W, so stride 2
    pads (1, 1) and (0, 1)."""
    affine, route, dtype = affine
    if route == "pallas":
        request.getfixturevalue("interpret_dw")
        monkeypatch.setattr(jdw, "pallas_depthwise_available",
                            lambda shape=None: True)
    rs = np.random.RandomState(stride * 4 + relu6 * 2 + affine)
    x, w, scale, bias = _dw_args(rs, (2, 7, 10, 8))
    if dtype == "bfloat16":  # values exact in bf16 on both sides
        x, w = (np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(
            jnp.float32)) for v in (x, w))
    n_args = 4 if affine else 2

    def jfwd(*a):
        kw = dict(scale=a[2], bias=a[3]) if affine else {}
        return jdw.depthwise_conv3x3(a[0], a[1], stride=stride, relu6=relu6,
                                     **kw)

    jargs = [jnp.asarray(v) for v in (x, w, scale, bias)][:n_args]
    jargs[:2] = [a.astype(getattr(jnp, dtype)) for a in jargs[:2]]
    want = np.asarray(jfwd(*jargs).astype(jnp.float32))
    jgrads = jax.grad(lambda *a: _loss_jax(jfwd(*a)),
                      argnums=tuple(range(n_args)))(*jargs)

    leaves = [t(v) for v in (x, w, scale, bias)][:n_args]
    leaves[:2] = [v.to(getattr(torch, dtype)) for v in leaves[:2]]
    leaves = [v.requires_grad_(True) for v in leaves]
    kw = dict(scale=leaves[2], bias=leaves[3]) if affine else {}
    out = tdw.depthwise_conv3x3(leaves[0], leaves[1], stride=stride,
                                relu6=relu6, **kw)
    got = out.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + 1e-6)
    if relu6:  # both ends of the clip are reached
        assert (want == 0).any() and (want == 6).any()
    _loss_torch(out).backward()
    rel = 1e-4 if dtype == "float32" else 2.0 ** -7
    for leaf, g, name in zip(leaves, jgrads, ("dx", "dw", "dscale", "dbias")):
        g = np.asarray(g.astype(jnp.float32))
        assert leaf.grad.shape == g.shape, name
        assert leaf.grad.dtype == leaf.dtype, name
        np.testing.assert_allclose(leaf.grad.float().numpy(), g, rtol=0,
                                   atol=rel * np.abs(g).max(), err_msg=name)


def test_wrapper_on_cpu_launches_nothing():
    """CPU tensors take the plain versions, bit for bit, forward and
    gradient, and count no launch; bf16 output and gradients come back in
    their operands' dtypes."""
    rs = np.random.RandomState(1)
    x, w, scale, bias = _dw_args(rs, (2, 6, 5, 12))
    before = (dict(tdw.launch_counts), dict(tpp.launch_counts))
    for dtype in (torch.float32, torch.bfloat16):
        xt = t(x).to(dtype).requires_grad_(True)
        wt = t(w).to(dtype).requires_grad_(True)
        out = tdw.depthwise_conv3x3(xt, wt, stride=1)
        assert out.dtype == dtype
        assert torch.equal(out, tdw.reference_impl(
            xt.detach(), wt.detach(), torch.ones(12), torch.zeros(12), 1,
            False))
        out.float().sum().backward()
        assert xt.grad.dtype == dtype and wt.grad.dtype == dtype
    y = t(rs.randn(2, 3, 4, 4, 8).astype(np.float32))
    a, b = t(rs.randn(8).astype(np.float32)), t(rs.randn(8).astype(np.float32))
    assert torch.equal(tpp.tpool_proto(y, y, a, b),
                       tpp.reference_impl(y, y, a, b))
    assert (tdw.launch_counts, tpp.launch_counts) == before


@pytest.mark.parametrize("bad", ["rank", "dtype", "taps", "scale", "stride",
                                 "noncontig", "empty"])
def test_depthwise_check_args_rejects(bad):
    """What the CUDA path refuses, checked in Python before any launch."""
    rs = np.random.RandomState(0)
    x, w, scale, bias = (t(v) for v in _dw_args(rs, (2, 5, 5, 8)))
    stride = 1
    if bad == "rank":
        x = x[0]
    if bad == "dtype":
        x = x.double()
    if bad == "taps":
        w = w[:2]
    if bad == "scale":
        scale = scale[:4]
    if bad == "stride":
        stride = 3
    if bad == "noncontig":
        x = x.transpose(1, 2)
    if bad == "empty":
        x = x[:0]
    with pytest.raises(ValueError):
        tdw.check_args(x, w, scale, bias, stride)
    tdw.check_args(*(t(v) for v in _dw_args(rs, (2, 5, 5, 8))), 2)


@pytest.mark.parametrize("bad", ["shape", "dtype", "affine", "c_not_8",
                                 "noncontig"])
def test_tpool_proto_check_args_rejects(bad):
    rs = np.random.RandomState(0)
    shape = (2, 3, 4, 4, 12 if bad == "c_not_8" else 16)
    y, ident = (t(rs.randn(*shape).astype(np.float32)) for _ in range(2))
    a, b = torch.ones(shape[-1]), torch.zeros(shape[-1])
    if bad == "shape":
        ident = ident[:, :2].contiguous()
    if bad == "dtype":
        ident = ident.to(torch.bfloat16)
    if bad == "affine":
        a = a.double()
    if bad == "noncontig":
        y = y.transpose(2, 3)
    with pytest.raises(ValueError):
        tpp.check_args(y, ident, a, b)


def test_build_knows_every_source(monkeypatch, tmp_path):
    """The six kernel sources are in csrc/ (``build.sources``, which the
    first load of any library builds), and a build without nvcc raises
    before writing anything."""
    names = ["tpool_fused", "tpool_fused_bwd", tdw.KERNEL, tpp.KERNEL,
             "bn_train", "crop_resize"]
    assert sorted(p.stem for p in build.CSRC_DIR.glob("*.cu")) == sorted(
        names)
    assert build.sources() == sorted(names)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(names)
    assert list(tmp_path.iterdir()) == []


# --------------------------------------------------------------------------
# (c), (d): MobileNetV2 with the flag
# --------------------------------------------------------------------------

MNV2_VARIANTS = [
    # (name, module kwargs, input shape, features)
    ("audio", dict(num_classes=5, dropout=0.0), (4, 1, 128, 64, 1), False),
    ("policy_trunk", dict(temporal_pooling=True), (6, 2, 80, 80, 3), True),
]


def _port_mnv2(kw, shape, features, v, stats):
    tmod = MobileNetV2(input_channels=shape[-1], head=not features,
                       use_pallas_dw=True, **kw)
    return load_flax_variables(tmod, v["params"], stats)


@pytest.fixture(scope="module", params=MNV2_VARIANTS,
                ids=[v[0] for v in MNV2_VARIANTS])
def mnv2_pair(request):
    """The flax weights and the flax module's outputs with the flag: eval
    and train mode, with the running statistics train mode leaves."""
    name, kw, shape, features = request.param
    rs = np.random.RandomState(len(name))
    x = rs.randn(*shape).astype(np.float32)
    jmod = JMobileNetV2(dtype=jnp.float32, use_pallas_dw=True, **kw)
    v = flax_variables(jmod, rs, jnp.asarray(x), train=False,
                       features=features)
    jx = jnp.asarray(x)
    want = {"eval": np.asarray(jax.jit(lambda v, x: jmod.apply(
        v, x, train=False, features=features))(v, jx))}
    out, mut = jax.jit(lambda v, x: jmod.apply(
        v, x, train=True, features=features, mutable=["batch_stats"]))(v, jx)
    want["train"] = np.asarray(out)
    want["stats"] = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
    return kw, x, features, v, want


def test_mobilenet_v2_pallas_dw_eval(mnv2_pair, monkeypatch):
    """(c) eval mode within 1e-4 (float32 convolutions summed in another
    order); every 3x3 depthwise layer (17, four at stride 2) goes through
    the op."""
    kw, x, features, v, want = mnv2_pair
    tmod = _port_mnv2(kw, x.shape, features, v, v["batch_stats"])
    calls = []
    real = tdw._dw
    monkeypatch.setattr(tdw, "_dw", lambda *a: calls.append(a[4]) or real(*a))
    with torch.no_grad():
        got = tmod(t(x), train=False, features=features)
    assert tuple(got.shape) == want["eval"].shape
    np.testing.assert_allclose(got.numpy(), want["eval"], atol=1e-4,
                               rtol=1e-4)
    assert sorted(calls) == [1] * 13 + [2] * 4


def test_mobilenet_v2_pallas_dw_train(mnv2_pair):
    """(c) train mode (batch moments): the output within 1e-4 of its largest
    entry, and each running statistic it leaves within 1e-4 of that
    buffer's largest entry. Batch moments over a few samples amplify
    float32 reordering: the sizes are the smallest at which the default
    path's port, too, stays within these bounds (at 24x24 the trunk's last
    BN normalizes three values and both paths differ from flax by 0.4)."""
    kw, x, features, v, want = mnv2_pair
    tmod = _port_mnv2(kw, x.shape, features, v, v["batch_stats"])
    got = tmod(t(x), train=True, features=features).detach().numpy()
    np.testing.assert_allclose(got, want["train"], rtol=0,
                               atol=1e-4 * np.abs(want["train"]).max())
    ref = dict(_port_mnv2(kw, x.shape, features, v,
                          want["stats"]).named_buffers())
    for k, buf in tmod.named_buffers():
        np.testing.assert_allclose(buf.numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-4 * float(ref[k].abs().max()),
                                   err_msg=k)


GUARD_CASES = [
    # small sizes: at 24x24 a boundary row or column is a large share of
    # every stride-2 layer's input
    ("audio", dict(num_classes=5), (2, 1, 64, 32, 1), False),
    ("policy_trunk", dict(temporal_pooling=True), (3, 2, 24, 24, 3), True),
]


@pytest.mark.parametrize("name,kw,shape,features", GUARD_CASES,
                         ids=[c[0] for c in GUARD_CASES])
def test_pallas_dw_flag_changes_the_function(name, kw, shape, features):
    """(d) on one set of weights the JAX package's flag moves the eval
    output by more than 10% of its largest entry: (c) holds the port to the
    flag's function, not to the default's."""
    rs = np.random.RandomState(len(name))
    x = jnp.asarray(rs.randn(*shape).astype(np.float32))
    mods = [JMobileNetV2(dtype=jnp.float32, use_pallas_dw=flag, **kw)
            for flag in (True, False)]
    v = flax_variables(mods[0], rs, x, train=False, features=features)
    on, off = (np.asarray(jax.jit(lambda v, x, m=m: m.apply(
        v, x, train=False, features=features))(v, x)) for m in mods)
    assert np.abs(on - off).max() > 0.1 * np.abs(on).max()


# --------------------------------------------------------------------------
# (e): the tiny flagship with the flag
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dw_bundle():
    return make_bundle(use_pallas_dw=True)


def test_adamml_pallas_dw_forward(dw_bundle, monkeypatch):
    """(e) decisions exact, logits within 1e-4; 17 depthwise calls in each
    of the three MobileNetV2s."""
    monkeypatch.setattr(tpolicy, "gumbel_decision", zero_noise_torch)
    cfg, tmodel, _, x, _, want = dw_bundle
    calls = []
    real = tdw._dw
    monkeypatch.setattr(tdw, "_dw", lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        logits, dec = tmodel([t(a) for a in x], 5.0)
    np.testing.assert_array_equal(dec.numpy(), want["decisions"])
    np.testing.assert_allclose(logits.numpy(), want["logits"], atol=1e-4,
                               rtol=1e-4)
    assert len(calls) == 51


def test_adamml_pallas_dw_eval_step(dw_bundle, monkeypatch):
    """(e) the eval step: decisions exact, logits and loss within 1e-4."""
    monkeypatch.setattr(tpolicy, "gumbel_decision", zero_noise_torch)
    cfg, tmodel, _, x, target, want = dw_bundle
    step = tsteps.make_adamml_eval_step(tmodel)
    logits, dec, loss = step(EvalState(), [t(a) for a in x], t(target), 0)
    np.testing.assert_array_equal(dec.numpy(), want["decisions"])
    np.testing.assert_allclose(logits.numpy(), want["logits"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(loss.item(), want["loss"], atol=1e-4,
                               rtol=1e-4)


# --------------------------------------------------------------------------
# (f): the kernel tools' stage-boundary prototype
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_tpool():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_bench_tpool", REPO / "tools" / "bench_tpool.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_ulp(v):
    v = np.abs(np.asarray(v, np.float32))
    return np.where(v == 0, 0.0, 2.0 ** (np.floor(np.log2(v + 1e-30)) - 7))


PROTO_CASES = [((4, 4, 8, 8, 16), "bfloat16"), ((3, 5, 4, 6, 32), "bfloat16"),
               ((2, 4, 8, 8, 16), "float32"), ((2, 3, 5, 5, 8), "float32"),
               ((2, 1, 8, 8, 8), "bfloat16")]


@pytest.mark.parametrize("shape,dtype", PROTO_CASES,
                         ids=[f"F{s[1]}-{d}" for s, d in PROTO_CASES])
def test_tpool_proto_matches_pallas(shape, dtype, bench_tpool, monkeypatch):
    """(f) against the eager ``tpool_rw``: bit-equal in bf16 (the same
    roundings in the same order), within 1e-6 in float32. Against the
    interpret-mode ``tpool_pallas``: float32 within 1e-6; bf16 within one
    bf16 ulp of z = y*a + b, the largest |z| of each pooling window: XLA
    contracts z's multiply-add, which can move z's rounding to bf16 by one
    ulp, and the residual add passes that on (the jitted ``tpool_rw`` does
    the same and equals ``tpool_pallas``)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    rs = np.random.RandomState(sum(shape))
    y, ident = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    a = (rs.randn(shape[-1]) * 0.3 + 1.0).astype(np.float32)
    b = (rs.randn(shape[-1]) * 0.5).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ty, ti = t(y).to(tdt), t(ident).to(tdt)
    got = tpp.reference_impl(ty, ti, t(a), t(b))
    assert got.dtype == tdt
    assert tuple(got.shape) == (shape[0], (shape[1] + 1) // 2) + shape[2:]
    got = got.float().numpy()
    z_max = temporal_pool((ty.float() * t(a) + t(b)).abs(), 3, 2,
                          "max").numpy()
    jy = jnp.asarray(ty.float().numpy()).astype(jdt)
    ji = jnp.asarray(ti.float().numpy()).astype(jdt)
    for name, fn in (("tpool_pallas", bench_tpool.tpool_pallas),
                     ("tpool_rw", bench_tpool.tpool_rw)):
        want = np.asarray(fn(jy, ji, jnp.asarray(a),
                             jnp.asarray(b)).astype(jnp.float32))
        assert want.shape == got.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        elif name == "tpool_rw":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert np.all(np.abs(got - want) <= _bf16_ulp(z_max)), name


@pytest.mark.parametrize("tool", ["bench_depthwise", "bench_tpool"])
def test_kernel_tools_refuse_without_a_card(tool, monkeypatch):
    """The tools measure the card only: without CUDA they raise before
    timing anything, and no plain version takes the kernel's place."""
    mod = importlib.import_module(f"adamml_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", [tool])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()
