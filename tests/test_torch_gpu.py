"""PyTorch port on a CUDA card: the fused epilogue's forward and backward
kernels against their plain versions, and the tiny float32 eval and train
steps on the card against the CPU.

Every test here carries the ``gpu`` marker and skips, with a reason, when no
card is present. The file imports no JAX, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.models.model_builder import build_model, example_inputs
from adamml_tpu_torch.ops.kernels import tpool_fused as ttp
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


def test_tiny_eval_step_on_card_matches_cpu():
    """Float32 with TF32 off: the same weights and inputs give the same
    logits on the card and on the CPU within 1e-3 (summation order), under
    a policy that selects every segment (rng_policy with threshold -1), so
    no generator stream enters the comparison."""
    _need_card()
    cfg = flagship_cfg(tiny=True)
    cfg.model.rng_policy, cfg.model.rng_threshold = True, -1.0
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = example_inputs(cfg, batch=4, device="cpu", seed=2)
        target = torch.arange(4) % cfg.model.num_classes
        out = []
        for dev in ("cuda", "cpu"):
            model, _ = build_model(cfg, device=dev)
            before = ttp.launch_counts[ttp.KERNEL]
            logits, dec, loss = make_adamml_eval_step(model)(
                EvalState(), [a.to(dev) for a in x], target.to(dev), 0)
            if dev == "cuda":
                assert ttp.launch_counts[ttp.KERNEL] - before == 2
            out.append((logits.cpu(), dec.cpu(), float(loss)))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    assert torch.equal(out[0][1], out[1][1])
    assert bool((out[0][1] == 1).all())
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(),
                               atol=1e-3)
    assert abs(out[0][2] - out[1][2]) < 1e-3


def _st_zero_noise(generator, logits, tau):
    """Zero-noise straight-through decision: no generator stream."""
    y = torch.softmax(logits / tau, dim=-1)
    hard = (logits.argmax(-1) == 1).float()
    return hard + y[..., 1] - y[..., 1].detach()


@pytest.mark.parametrize("phase", ["main", "policy"])
def test_tiny_train_step_on_card_matches_cpu(phase, monkeypatch):
    """One float32 step of each phase from the same weights (8 clips at
    64x64, dropout 0, zero-noise decisions, TF32 off): losses within 1e-3
    relative; SGD updates each within 0.1 * lr of the CPU's, and 99% of the
    Adam updates within 0.1 * p_lr (Adam maps each gradient element to
    about +-p_lr, so elements within float32 noise of 0 may flip). The
    main phase launches both kernels twice (F=4 pools twice), the policy
    phase the forward only."""
    _need_card()
    monkeypatch.setattr(tpolicy, "gumbel_decision", _st_zero_noise)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = flagship_cfg(tiny=True)
    cfg.model.dropout = 0.0
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
        m = step(state, [a.to(dev) for a in x], target.to(dev), lr, p_lr,
                 [1.0, 0.05], seed=0)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ttp.launch_counts[ttp.KERNEL] - counts[ttp.KERNEL] == 2
            assert (ttp.launch_counts[ttp.KERNEL_BWD]
                    - counts[ttp.KERNEL_BWD]) == (2 if phase == "main" else 0)
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
