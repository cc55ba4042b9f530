"""PyTorch port on a CUDA card: the fused epilogue's forward and backward
kernels, the depthwise kernel (forward and flipped-tap input gradient) and
the stage-boundary prototype kernel against their plain versions, the
tiny float32 eval and train steps on the card against the CPU, with the
depthwise flag off and on, and the device preprocessing and a tiny
train_adamml run on the card against the CPU.

Every test here carries the ``gpu`` marker and skips, with a reason, when no
card is present. The file imports no JAX, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import json
import time

import numpy as np
import pytest
import torch

from adamml_tpu_torch.cli import train_adamml
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.configs.config import arg_parser, config_from_args
from adamml_tpu_torch.data.device_pipeline import make_batch_preprocessor
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.models.model_builder import build_model, example_inputs
from adamml_tpu_torch.ops.augment import policy_stream
from adamml_tpu_torch.ops.kernels import depthwise as tdw
from adamml_tpu_torch.ops.kernels import tpool_fused as ttp
from adamml_tpu_torch.ops.kernels import tpool_proto as tpp
from adamml_tpu_torch.train import curriculum as cur
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.steps import (make_adamml_eval_step,
                                          make_adamml_train_step)
from adamml_tpu_torch.train.train_state import (EvalState, StageFlags,
                                                TrainState)

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _args(n, f, h, w, c, r, s, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((n, f, h, w, c), generator=g).to(dtype).cuda()
    ident = torch.randn((n, f, h, w, c), generator=g).to(dtype).cuda()
    a = (1.0 + 0.3 * torch.randn((r, s, c), generator=g)).cuda()
    b = (0.1 * torch.randn((r, s, c), generator=g)).cuda()
    return y, ident, a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    dict(n=8, f=8, h=5, w=7, c=64, r=1, s=1),
    dict(n=20, f=4, h=3, w=3, c=32, r=2, s=5),
    dict(n=6, f=3, h=4, w=4, c=8, r=1, s=3),
    dict(n=4, f=5, h=2, w=6, c=16, r=2, s=1),
])
def test_cuda_kernel_matches_plain(shape, dtype):
    _need_card()
    y, ident, a, b = _args(**shape, dtype=dtype)
    before = ttp.launch_counts[ttp.KERNEL]
    got = ttp.fused_bn_add_relu_tpool(y, ident, a, b)
    torch.cuda.synchronize()
    assert ttp.launch_counts[ttp.KERNEL] == before + 1
    # no FMA contraction in the kernel: bit-equal to the plain version
    torch.testing.assert_close(got, ttp.reference_impl(y, ident, a, b),
                               rtol=0, atol=0)


def _ct(y, seed=2):
    n, f, h, w, c = y.shape
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, (f - 1) // 2 + 1, h, w, c), generator=g).to(
        y.dtype).cuda()


def _assert_bwd_close(got, want):
    """dy and dident bit-equal (the kernel rounds where the plain version
    does); da and db within 1e-4 of their largest entry (float32 sums of up
    to F*H*W*N/(R*S) terms taken in another order)."""
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, w in zip(got[2:], want[2:]):
        assert tuple(g.shape) == tuple(w.shape)
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()) + 1e-6)


BWD_SHAPES = [
    dict(n=8, f=8, h=5, w=7, c=64, r=1, s=1),
    dict(n=20, f=4, h=3, w=3, c=32, r=2, s=5),
    dict(n=6, f=3, h=4, w=4, c=8, r=1, s=3),
    dict(n=4, f=5, h=2, w=6, c=16, r=2, s=1),
    dict(n=10, f=2, h=7, w=7, c=1040, r=1, s=5),  # two channel blocks
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_cuda_bwd_kernel_matches_plain(shape, dtype):
    _need_card()
    y, ident, a, b = _args(**shape, dtype=dtype)
    ct = _ct(y)
    before = ttp.launch_counts[ttp.KERNEL_BWD]
    got = ttp.fused_bn_add_relu_tpool_bwd(y, ident, a, b, ct)
    torch.cuda.synchronize()
    assert ttp.launch_counts[ttp.KERNEL_BWD] == before + 1
    _assert_bwd_close(got, ttp.reference_bwd(y, ident, a, b, ct))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_bwd_kernel_routes_ties_to_first_max(dtype):
    """All frames equal and positive: every window's cotangent goes to its
    first frame (tests/test_pallas.py builds the same tie)."""
    _need_card()
    g = torch.Generator().manual_seed(0)
    n, f, h, w, c = 2, 4, 8, 8, 8
    frame = torch.randn((n, 1, h, w, c), generator=g).abs() + 0.5
    y = frame.repeat(1, f, 1, 1, 1).to(dtype).cuda()
    ident = torch.zeros_like(y)
    a = torch.ones((1, 1, c), device="cuda")
    b = torch.zeros((1, 1, c), device="cuda")
    ct = _ct(y, seed=1)
    got = ttp.fused_bn_add_relu_tpool_bwd(y, ident, a, b, ct)
    want = ttp.reference_bwd(y, ident, a, b, ct)
    _assert_bwd_close(got, want)
    # window 0 is frames 0-1, window 1 frames 1-3: frames 0 and 1 take one
    # window each, frames 2 and 3 nothing
    torch.testing.assert_close(got[1][:, :2], ct, rtol=0, atol=0)
    assert bool((got[1][:, 2:] == 0).all())


def test_cuda_autograd_runs_both_kernels():
    _need_card()
    y, ident, a, b = _args(10, 4, 3, 5, 24, 1, 5, torch.bfloat16)
    leaves = [t.detach().requires_grad_(True) for t in (y, ident, a, b)]
    counts = dict(ttp.launch_counts)
    out = ttp.fused_bn_add_relu_tpool(*leaves)
    ct = _ct(y)
    out.backward(ct)
    torch.cuda.synchronize()
    assert ttp.launch_counts[ttp.KERNEL] == counts[ttp.KERNEL] + 1
    assert ttp.launch_counts[ttp.KERNEL_BWD] == counts[ttp.KERNEL_BWD] + 1
    _assert_bwd_close([t.grad for t in leaves],
                      ttp.reference_bwd(y, ident, a, b, ct))


def test_cuda_kernel_refuses_grad_and_bad_args():
    """Gradients are taken (test_cuda_autograd_runs_both_kernels); what the
    kernels cannot take raises."""
    _need_card()
    y, ident, a, b = _args(2, 2, 2, 2, 8, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="ct must be"):
        ttp.fused_bn_add_relu_tpool_bwd(y, ident, a, b,
                                        _ct(y)[:, :, :1].contiguous())
    with pytest.raises(ValueError):
        ttp.fused_bn_add_relu_tpool(y.detach()[:, :1].contiguous(),
                                    ident[:, :1].contiguous(), a, b)
    with pytest.raises(ValueError):
        ttp.fused_bn_add_relu_tpool(y.detach(), ident.cpu(), a, b)


# depthwise kernel launches (forward, input gradient) of one tiny step with
# use_pallas_dw=True: 17 depthwise layers in each MobileNetV2; the main
# phase's audio backbone backward runs 13 stride-1 input gradients; the
# policy phase recomputes the two trunks' forward (remat) and runs their 26
DW_STEP = {"main": (51, 13), "policy": (85, 26)}


def _dw_counts():
    return (tdw.launch_counts[tdw.KERNEL], tdw.launch_counts[tdw.KERNEL_DX])


def _dw_args(b, h, w, c, dtype, seed=3, tap_dtype=None):
    """x, the taps as _DepthwiseConv passes them (a (3, 3, C) view of a
    (C, 1, 3, 3) weight; in x's dtype unless ``tap_dtype``), scale, bias."""
    g = torch.Generator().manual_seed(seed)
    x = (2.0 * torch.randn((b, h, w, c), generator=g)).to(dtype).cuda()
    weight = torch.randn((c, 1, 3, 3), generator=g).to(tap_dtype or dtype)
    taps = weight.cuda()[:, 0].permute(1, 2, 0)
    scale = (1.0 + 0.3 * torch.randn(c, generator=g)).cuda()
    bias = (0.5 * torch.randn(c, generator=g)).cuda()
    return x, taps, scale, bias


DW_SHAPES = [
    dict(b=4, h=20, w=20, c=96),    # C % 8 == 0: 8 channels a thread
    dict(b=2, h=9, w=11, c=32),     # odd H and W
    dict(b=3, h=6, w=6, c=24),      # stride 2 pads (0, 1)
    dict(b=2, h=7, w=5, c=12),      # C % 8 != 0: 4 channels a thread
    # sizes that cross the tiles' edges (H, W no multiple of a tile), one
    # row, one column, one image, C = 8 and 960, and a flagship layer
    dict(b=2, h=33, w=70, c=24),
    dict(b=3, h=1, w=37, c=8),
    dict(b=3, h=35, w=1, c=12),
    dict(b=1, h=19, w=19, c=960),
    dict(b=1, h=1, w=1, c=960),
    dict(b=40, h=128, w=128, c=32),
]


@pytest.mark.parametrize("taps", ["same", "f32"], ids=["taps_x", "taps_f32"])
@pytest.mark.parametrize("relu6", [False, True], ids=["linear", "relu6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_cuda_depthwise_matches_plain(shape, stride, dtype, relu6, taps):
    """The kernel sums the nine products in the plain version's order with
    no FMA contraction, then the affine, the clip and one rounding:
    bit-equal, with the identity affine (no scale, no bias) or an affine
    with ReLU6, taps in x's dtype or float32, read through the model's
    permuted view."""
    _need_card()
    x, w, scale, bias = _dw_args(**shape, dtype=dtype,
                                 tap_dtype=torch.float32 if taps == "f32"
                                 else None)
    if not relu6:
        scale = bias = None
    before = _dw_counts()
    got = tdw.depthwise_conv3x3(x, w, stride=stride, scale=scale,
                                bias=bias, relu6=relu6)
    torch.cuda.synchronize()
    assert _dw_counts() == (before[0] + 1, before[1])
    want = tdw.reference_impl(x, w, scale, bias, stride, relu6)
    assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_cuda_depthwise_flipped_taps(shape, dtype):
    """The input gradient's launch: the taps read flipped in both spatial
    axes, bit-equal to the plain version on a flipped copy."""
    _need_card()
    x, w, _, _ = _dw_args(**shape, dtype=dtype)
    before = _dw_counts()
    got = tdw._dw(x, w, None, None, 1, False, tdw.KERNEL_DX, True)
    torch.cuda.synchronize()
    assert _dw_counts() == (before[0], before[1] + 1)
    torch.testing.assert_close(
        got, tdw.reference_impl(x, w.flip(0, 1), None, None, 1, False),
        rtol=0, atol=0)


@pytest.mark.parametrize("stride", [1, 2])
def test_cuda_depthwise_is_deterministic(stride):
    """Every output is one thread's sum in one order: two calls give the
    same bytes."""
    _need_card()
    x, w, scale, bias = _dw_args(8, 40, 40, 144, torch.bfloat16)
    first = tdw.depthwise_conv3x3(x, w, stride=stride, scale=scale,
                                  bias=bias, relu6=True)
    second = tdw.depthwise_conv3x3(x, w, stride=stride, scale=scale,
                                   bias=bias, relu6=True)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def _device_kernels(fn, path):
    """Names of the kernels ``fn`` puts on the card: the "kernel" events of
    a torch.profiler trace written to ``path``. A later session in a
    process can miss its first kernels (and a trace its last), so runs of
    marker kernels (torch.cuda._sleep's spin_kernel) come before and after
    ``fn``; the trace must begin and end with a marker."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        torch.cuda._sleep(10_000_000)
        for _ in range(32):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        for _ in range(32):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in sorted(
        (e for e in events if e.get("ph") == "X" and e.get("cat") ==
         "kernel"), key=lambda e: float(e["ts"]))]
    marks = ["spin_kernel" in n for n in names]
    assert marks and marks[0] and marks[-1], names
    return [n for n, m in zip(names, marks) if not m]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_depthwise_one_kernel_a_call(dtype, tmp_path):
    """A forward call as _DepthwiseConv makes it, and a stride-1
    input-gradient call on a contiguous cotangent, each put exactly one
    kernel on the card (torch.profiler)."""
    _need_card()
    x, w, _, _ = _dw_args(4, 20, 20, 96, dtype)
    with torch.no_grad():
        tdw.depthwise_conv3x3(x, w)
    fwd = _device_kernels(lambda: tdw.depthwise_conv3x3(x, w),
                          tmp_path / "fwd.json")
    xg = x.detach().requires_grad_(True)
    out = tdw.depthwise_conv3x3(xg, w)
    ct = torch.randn(out.shape, device="cuda").to(dtype)
    torch.autograd.grad(out, xg, ct, retain_graph=True)
    dx = _device_kernels(lambda: torch.autograd.grad(out, xg, ct,
                                                     retain_graph=True),
                         tmp_path / "dx.json")
    assert len(fwd) == 1 and "dw3x3" in fwd[0], fwd
    assert len(dx) == 1 and "dw3x3" in dx[0], dx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_cuda_depthwise_gradients(stride, dtype):
    """Autograd on the card: at stride 1 the input gradient is the kernel
    again with flipped taps (one KERNEL_DX launch), bit-equal to the plain
    version of that call; at stride 2 it is a float32 cuDNN convolution.
    Every gradient within 1e-4 of its largest entry of the same graph on
    the CPU (float32 library convolutions summed in another order; in bf16
    one rounding of values that agree to that)."""
    _need_card()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x, taps, scale, bias = _dw_args(3, 9, 10, 16, dtype)
        g = torch.Generator().manual_seed(4)
        ct = torch.randn((3, -(-9 // stride), 5 if stride == 2 else 10, 16),
                         generator=g).to(dtype)
        grads = {}
        for dev in ("cuda", "cpu"):
            leaves = [t.detach().to(dev).requires_grad_(True)
                      for t in (x, taps, scale, bias)]
            before = _dw_counts()
            out = tdw.depthwise_conv3x3(leaves[0], leaves[1], stride=stride,
                                        scale=leaves[2], bias=leaves[3],
                                        relu6=True)
            out.backward(ct.to(dev))
            if dev == "cuda":
                torch.cuda.synchronize()
                assert _dw_counts() == (before[0] + 1,
                                        before[1] + (stride == 1))
            grads[dev] = [leaf.grad.cpu() for leaf in leaves]
            if dev == "cuda" and stride == 1:
                mask = ((out > 0) & (out < 6)).float()
                gc = (ct.cuda().float() * mask * scale).to(dtype)
                want = tdw.reference_impl(
                    gc, leaves[1].detach().flip(0, 1),
                    torch.ones_like(scale), torch.zeros_like(bias), 1, False)
                torch.testing.assert_close(leaves[0].grad, want, rtol=0,
                                           atol=0)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert got.dtype == want.dtype
        torch.testing.assert_close(
            got.float(), want.float(), rtol=0,
            atol=1e-4 * float(want.float().abs().max())
            + (float(want.float().abs().max()) * 2.0 ** -8
               if dtype == torch.bfloat16 else 0.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 2, 5, 8])
def test_cuda_tpool_proto_matches_plain(f, dtype):
    """The prototype kernel rounds where its plain version does (z, then the
    residual add): bit-equal."""
    _need_card()
    g = torch.Generator().manual_seed(f)
    shape = (6, f, 5, 7, 24)
    y = torch.randn(shape, generator=g).to(dtype).cuda()
    ident = torch.randn(shape, generator=g).to(dtype).cuda()
    a = (1.0 + 0.3 * torch.randn(24, generator=g)).cuda()
    b = (0.1 * torch.randn(24, generator=g)).cuda()
    before = tpp.launch_counts[tpp.KERNEL]
    got = tpp.tpool_proto(y, ident, a, b)
    torch.cuda.synchronize()
    assert tpp.launch_counts[tpp.KERNEL] == before + 1
    torch.testing.assert_close(got, tpp.reference_impl(y, ident, a, b),
                               rtol=0, atol=0)


def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _tiny_eval_step(use_pallas_dw: bool):
    """Float32 with TF32 off: the same weights and inputs give the same
    logits on the card and on the CPU within 1e-3 (summation order), under
    a policy that selects every segment (rng_policy with threshold -1), so
    no generator stream enters the comparison. With the depthwise flag the
    audio backbone's 17 depthwise layers run the kernel."""
    _need_card()
    cfg = flagship_cfg(tiny=True)
    cfg.model.rng_policy, cfg.model.rng_threshold = True, -1.0
    cfg.model.use_pallas_dw = use_pallas_dw
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    _no_tf32()
    try:
        x = example_inputs(cfg, batch=4, device="cpu", seed=2)
        target = torch.arange(4) % cfg.model.num_classes
        out = []
        for dev in ("cuda", "cpu"):
            model, _ = build_model(cfg, device=dev)
            before = ttp.launch_counts[ttp.KERNEL]
            dw_before = _dw_counts()
            logits, dec, loss = make_adamml_eval_step(model)(
                EvalState(), [a.to(dev) for a in x], target.to(dev), 0)
            if dev == "cuda":
                assert ttp.launch_counts[ttp.KERNEL] - before == 2
                assert _dw_counts()[0] - dw_before[0] == (
                    17 if use_pallas_dw else 0)
            out.append((logits.cpu(), dec.cpu(), float(loss)))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    assert torch.equal(out[0][1], out[1][1])
    assert bool((out[0][1] == 1).all())
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(),
                               atol=1e-3)
    assert abs(out[0][2] - out[1][2]) < 1e-3


def test_tiny_eval_step_on_card_matches_cpu():
    _tiny_eval_step(use_pallas_dw=False)


def test_tiny_dw_eval_step_on_card_matches_cpu():
    _tiny_eval_step(use_pallas_dw=True)


def test_tiny_dw_forward_on_card_matches_cpu(monkeypatch):
    """use_pallas_dw=True, float32, TF32 off: the policy net's logits (both
    trunks) and the main net's under fixed decisions, on the card and on
    the CPU from the same weights, within 1e-3; 51 depthwise launches."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = flagship_cfg(tiny=True)
    cfg.model.use_pallas_dw = True
    cpu, _ = build_model(cfg, device="cpu")
    gpu, _ = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    x = example_inputs(cfg, batch=4, device="cpu", seed=3)
    n, s = x[0].shape[:2]
    dec = (torch.arange(2 * n * s) % 3 != 0).float().reshape(2, n * s)
    outs = []
    before = _dw_counts()
    for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
        xs = [a.to(dev) for a in x]
        with torch.no_grad():
            _, p_logits = model.policy_net(
                [policy_stream(xs[0], cfg.model.policy_input_size), xs[1]],
                5.0)
            m_logits = model.main_net(
                [a.reshape((n * s,) + tuple(a.shape[2:])) for a in xs],
                dec.to(dev), seq_groups=s)
        outs.append((p_logits.cpu(), m_logits.cpu()))
    assert _dw_counts()[0] - before[0] == 51
    for got, want in zip(*outs):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


def _st_zero_noise(generator, logits, tau):
    """Zero-noise straight-through decision: no generator stream."""
    y = torch.softmax(logits / tau, dim=-1)
    hard = (logits.argmax(-1) == 1).float()
    return hard + y[..., 1] - y[..., 1].detach()


def _tiny_train_step(phase, use_pallas_dw, monkeypatch):
    """One float32 step of each phase from the same weights (8 clips at
    64x64, dropout 0, zero-noise decisions, TF32 off): losses within 1e-3
    relative; SGD updates each within 0.1 * lr of the CPU's, and 99% of the
    Adam updates within 0.1 * p_lr (Adam maps each gradient element to
    about +-p_lr, so elements within float32 noise of 0 may flip). The
    main phase launches both epilogue kernels twice (F=4 pools twice), the
    policy phase the forward only; with the depthwise flag the depthwise
    kernel's launches are DW_STEP's."""
    _need_card()
    monkeypatch.setattr(tpolicy, "gumbel_decision", _st_zero_noise)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = flagship_cfg(tiny=True)
    cfg.model.dropout = 0.0
    cfg.model.use_pallas_dw = use_pallas_dw
    cfg.data.input_size = 64
    lr, p_lr = 1e-3, 1e-2
    x = example_inputs(cfg, batch=8, device="cpu", seed=5)
    target = torch.arange(8) % cfg.model.num_classes
    cpu, _ = build_model(cfg, device="cpu")
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    flags = (StageFlags.main_phase() if phase == "main"
             else StageFlags.policy_phase())
    out = {}
    for dev in ("cuda", "cpu"):
        model, _ = build_model(cfg, device=dev)
        model.load_state_dict(start)
        state = TrainState(
            build_optimizer("main", cfg.optim, model.main_net.parameters()),
            build_optimizer("policy", cfg.optim,
                            model.policy_net.parameters()))
        step = make_adamml_train_step(model, flags=flags,
                                      penalty_type="blockdrop", gammas=10.0,
                                      clip_gradient=None)
        counts = dict(ttp.launch_counts)
        dw_before = _dw_counts()
        m = step(state, [a.to(dev) for a in x], target.to(dev), lr, p_lr,
                 [1.0, 0.05], seed=0)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ttp.launch_counts[ttp.KERNEL] - counts[ttp.KERNEL] == 2
            assert (ttp.launch_counts[ttp.KERNEL_BWD]
                    - counts[ttp.KERNEL_BWD]) == (2 if phase == "main" else 0)
            dw = tuple(a - b for a, b in zip(_dw_counts(), dw_before))
            assert dw == (DW_STEP[phase] if use_pallas_dw else (0, 0))
        out[dev] = (float(m["loss"]), {k: v.cpu() for k, v in
                                       model.state_dict().items()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-3 * abs(out["cpu"][0])
    live = f"{phase}_net."
    step_lr = lr if phase == "main" else p_lr
    close = total = 0
    for name, p in cpu.named_parameters():
        got, want = out["cuda"][1][name], out["cpu"][1][name]
        if not name.startswith(live):
            assert torch.equal(got, start[name]), name
            continue
        off = (got - want).abs() > 0.1 * step_lr
        if phase == "main":
            assert not bool(off.any()), name
        close += int((~off).sum())
        total += off.numel()
    assert close / total >= 0.99


@pytest.mark.parametrize("phase", ["main", "policy"])
def test_tiny_train_step_on_card_matches_cpu(phase, monkeypatch):
    _tiny_train_step(phase, False, monkeypatch)


@pytest.mark.parametrize("phase", ["main", "policy"])
def test_tiny_dw_train_step_on_card_matches_cpu(phase, monkeypatch):
    _tiny_train_step(phase, True, monkeypatch)


def _st_zero_noise(generator, logits, tau):
    """Zero-noise straight-through decision: no generator stream, so the
    card and the CPU take the same decisions."""
    y = torch.softmax(logits / tau, dim=-1)
    hard = (logits.argmax(-1) == 1).float()
    return hard + y[..., 1] - y[..., 1].detach()


def test_preprocess_on_card_matches_cpu(monkeypatch):
    """One synthetic batch of all four modalities (train crops and flips,
    then 3 oversample crops) through make_batch_preprocessor on the card
    and on the CPU, float32 with TF32 off: within 1e-3 (the einsum
    contractions and cuFFT sum in another order)."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    argv = ("--dataset synthetic --modality rgb flow rgbdiff sound "
            "--groups 2 --frames_per_group 2 --num_segments 2 "
            "--dense_sampling --input_size 32 --audio_length 0.16 "
            "--compute_dtype float32 --num_crops 3 -b 4").split()
    cfg = config_from_args(arg_parser().parse_args(argv))
    cfg.data.canvas_size = (64, 96)
    for train in (True, False):
        ds = cur._make_dataset(cfg, is_train=train, num_clips=2)
        batch = next(iter(cur._make_loader(cfg, ds, is_train=train)))
        got = {}
        for dev in ("cuda", "cpu"):
            x, y = make_batch_preprocessor(cfg, train=train, num_segments=2,
                                           device=dev)(batch)
            assert all(t_.device.type == dev for t_ in x + [y])
            got[dev] = [t_.cpu() for t_ in x]
        for m, a, b in zip(cfg.model.modality, got["cuda"], got["cpu"]):
            assert a.shape == b.shape, m
            assert float((a - b).abs().max()) <= 1e-3, m


def test_tiny_cli_on_card_matches_cpu(monkeypatch, tmp_path):
    """train_adamml.main at the tiny settings on the card and on the CPU,
    float32, dropout 0, zero-noise decisions, TF32 off: the warmup epoch's
    loss (the same weights and batch) within 1e-3 relative; every epoch's
    loss finite; the same artifacts; the epilogue kernels launched on the
    card (2 stage boundaries at 4 frames)."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(tpolicy, "gumbel_decision", _st_zero_noise)
    argv = ("--dataset synthetic --modality rgb sound -d 18 --groups 4 "
            "--num_segments 2 --dense_sampling --val_num_clips 2 -b 8 "
            "--epochs 1 --warmup_epochs 1 --finetune_epochs 1 "
            "--input_size 32 --audio_length 0.16 --synthetic_length 8 "
            "--causality_modeling lstm --cost_weights 1.0 0.05 "
            "--compute_dtype float32 --scale_range 36 48 -j 2 --dropout 0 "
            "--lr_scheduler multisteps --lr_steps 1 --seed 5").split()
    losses = {}
    train_epoch = cur.train_epoch

    def rec(*args, **kw):
        state, s = train_epoch(*args, **kw)
        losses.setdefault(dev, []).append(s["loss"])
        return state, s

    monkeypatch.setattr(cur, "train_epoch", rec)
    names = {}
    for dev in ("cuda", "cpu"):
        before = dict(ttp.launch_counts)
        assert train_adamml.main(argv + ["--logdir", str(tmp_path / dev)],
                                 device=dev) == 0
        launched = ttp.launch_counts[ttp.KERNEL] - before[ttp.KERNEL]
        assert (launched > 0) == (dev == "cuda")
        folder = next(p for p in (tmp_path / dev).iterdir())
        names[dev] = {p.name for p in folder.iterdir()}
    assert names["cuda"] == names["cpu"]
    assert len(losses["cuda"]) == len(losses["cpu"]) == 4
    assert all(np.isfinite(losses["cuda"]))
    assert abs(losses["cuda"][0] - losses["cpu"][0]) <= 1e-3 * abs(
        losses["cpu"][0])


def test_native_and_pil_decode_on_the_card_host(tmp_path):
    """One generated video (8 frames at 256x340) through both decoders of
    the card's host: every frame counted under its decoder, the geometry
    equal, the pixels within 1 LSB (IDCT rounding). Skips, naming the
    reason, where the native library does not load."""
    _need_card()
    from adamml_tpu_torch.data import loaders
    from adamml_tpu_torch.data.native_decode import (load_error,
                                                     native_available)
    from adamml_tpu_torch.data.video_dataset import VideoDataset
    from adamml_tpu_torch.tools.bench_pipeline import generate_tree

    generate_tree(str(tmp_path), videos=1, frames=8)
    if not native_available():
        pytest.skip(f"the native decoder does not load: {load_error()}")
    out = {}
    for native in (True, False):
        ds = VideoDataset(str(tmp_path / "rgb"), "val.txt", num_groups=8,
                          is_train=False, separator=";",
                          use_native_decoder=native)
        before = dict(loaders.decode_counts)
        out[native] = ds.get_data(ds.video_list[0], np.arange(1, 9))
        counted = {k: loaders.decode_counts[k] - before[k] for k in before}
        assert counted == ({"native": 8, "pil": 0} if native
                           else {"native": 0, "pil": 8})
    np.testing.assert_array_equal(out[True]["hw"], [256, 340])
    np.testing.assert_array_equal(out[False]["hw"], [256, 340])
    diff = out[True]["frames"].astype(int) - out[False]["frames"].astype(int)
    assert np.abs(diff).max() <= 1
