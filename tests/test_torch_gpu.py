"""PyTorch port on a CUDA card: the port's card-check suite
(``chip_smoke.py`` times each kernel alone, holding only what it times to
its plain version and the two full-width steps it runs to their launch
counts; the stage shapes and the BN call census here are its own).

The fused epilogue's forward and backward kernels, the depthwise kernel
(forward and flipped-tap input gradient), the stage-boundary prototype
kernel and train-mode BN's six kernels against their plain versions (the
epilogue at the flagship's stage-boundary shapes too; the backward also for
its determinism, its plan's sum order, a channel block, its kernels in a
profile, a replayed graph and its build log; BN at every call of a flagship
main step, and its launches against a step's train-mode BN calls); the
tiny float32 eval and train steps and forward on the card against the CPU,
with the depthwise flag off and on; eval capacity's packed rows on the
card; the device preprocessing; a tiny train_adamml run on the card
against the CPU, every epoch's epilogue launches counted, and the K = 2
curriculum's traces each holding one replay; the multi-step dispatch's
replayed CUDA graph against the same steps run as single steps; and
SlowFast's 3D convolutions in bf16 channels-last against float32; a small
MViT's train step on the card against the CPU. The
loader's page-locked batch buffers from torch's caching host allocator: a
buffer reused only after the copy that read it (the stream held before
each copy, on the current stream, a side stream and a second card), a
consumer holding every batch, and the K = 2 capture while the loader's
threads fill buffers.

Every test here carries the ``gpu`` marker and skips, with a reason, when no
card is present. The data-parallel checks (parallel/mesh.py): an NCCL
process group of one, in this process, is the single process bit for bit,
and holds its collectives in a replayed CUDA graph; gloo refuses a graph;
two processes sharing the card over gloo match the single process
(tests/test_torch_multiprocess.py's comparison). The kernel, update and
memory tools (bench_tpool's and bench_tpool_bwd's rows agree,
bench_update's rows agree; mem_analysis reads a step's memory and its
epilogue launches). The file imports no JAX, so it also runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import json
import re
import time

import numpy as np
import pytest
import torch

from adamml_tpu_torch.cli import train_adamml
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.configs.config import arg_parser, config_from_args
from adamml_tpu_torch.data.dataflow import HostDataLoader
from adamml_tpu_torch.data.device_pipeline import (
    make_batch_preprocessor, make_unimodal_preprocessor, to_device)
from adamml_tpu_torch.data.synthetic import SyntheticVideoDataset
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.models.model_builder import build_model, example_inputs
from adamml_tpu_torch.ops.augment import (plain_crop_resize, policy_stream,
                                          rgbdiff_from_frames)
from adamml_tpu_torch.ops.kernels import bn_train as tbn
from adamml_tpu_torch.ops.kernels import crop_resize as tcr
from adamml_tpu_torch.ops.kernels import depthwise as tdw
from adamml_tpu_torch.ops.kernels import tpool_fused as ttp
from adamml_tpu_torch.ops.kernels import tpool_proto as tpp
from adamml_tpu_torch.tools import crop_cases as cc
from adamml_tpu_torch.tools.timing import bf16_ulp, within_one_bf16_ulp
from adamml_tpu_torch.train import curriculum as cur
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.steps import (make_adamml_eval_step,
                                          make_adamml_multi_step,
                                          make_adamml_train_step)
from adamml_tpu_torch.train.train_state import (EvalState, StageFlags,
                                                TrainState)
from adamml_tpu_torch.utils import profiling
from chip_smoke import BN_BATCH, STAGES, bn_call_hooks, bn_calls, bn_launches

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
] + [dict(n=40, f=f, h=h, w=w, c=c, r=1, s=1) for f, h, w, c in STAGES])
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
# the stage boundaries in training (one group a segment: R = 1, S = 5)
BWD_STAGE_SHAPES = [dict(n=40, f=f, h=h, w=w, c=c, r=1, s=5)
                    for f, h, w, c in STAGES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES + BWD_STAGE_SHAPES)
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


def _bwd_args(n, f, h, w, c, r, s, dtype, seed=1):
    y, ident, a, b = _args(n, f, h, w, c, r, s, dtype, seed)
    return y, ident, a, b, _ct(y, seed + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES + BWD_STAGE_SHAPES[2:])
def test_cuda_bwd_kernel_is_deterministic_and_follows_its_plan(shape,
                                                                dtype):
    """Two launches on the same inputs give the same bits, and the
    kernel's per-row sums are bit for bit ``planned_row_sums`` on the CPU:
    the order ``bwd_plan`` states (at stage 3, whose plan splits the
    channels into slices; stages 1 and 2 would take the host tens of
    seconds to emulate)."""
    _need_card()
    args = _bwd_args(**shape, dtype=dtype)
    first = ttp.fused_bn_add_relu_tpool_bwd(*args)
    second = ttp.fused_bn_add_relu_tpool_bwd(*args)
    for g, g2 in zip(first, second):
        assert torch.equal(g, g2)
    y = args[0]
    plan = ttp.bwd_plan(*y.shape, y.element_size(),
                        torch.cuda.get_device_properties(
                            0).multi_processor_count)
    rows = ttp._launch_bwd_rows(*args)[2].cpu()
    cpu = [t.cpu() for t in args]
    assert torch.equal(rows, ttp.planned_row_sums(ttp.routed_dpre(*cpu),
                                                  cpu[0], plan))


def test_cuda_fwd_channel_block_is_bit_identical():
    """The forward kernel on the upper channel block [C/2, C) of the
    stage-2 shape (the JAX kernel's shard-local channel block,
    tests/test_tpool_sharded.py's 2-D mesh), made contiguous, with the
    affine's slice: bit for bit that block of its full-C launch."""
    _need_card()
    args = _args(40, 4, 28, 28, 512, 1, 5, torch.bfloat16)
    whole = ttp.fused_bn_add_relu_tpool(*args)
    got = ttp.fused_bn_add_relu_tpool(
        *(t[..., 256:].contiguous() for t in args))
    assert torch.equal(got, whole[..., 256:].contiguous())


def test_cuda_bwd_channel_block_is_bit_identical():
    """The upper channel block [C/2, C) of the stage-2 train shape, made
    contiguous, with the affine's slice: dy, dident, da and db bit for bit
    that block of the full-C launch (the sum order does not depend on C)."""
    _need_card()
    args = _bwd_args(40, 4, 28, 28, 512, 1, 5, torch.bfloat16)
    whole = ttp.fused_bn_add_relu_tpool_bwd(*args)
    got = ttp.fused_bn_add_relu_tpool_bwd(
        *(t[..., 256:].contiguous() for t in args))
    for g, w in zip(got, whole):
        assert torch.equal(g, w[..., 256:].contiguous())


def test_cuda_bwd_one_call_puts_the_planned_kernels(tmp_path):
    """One backward launch at the stage-3 train shape puts the plan's
    kernels on the card (torch.profiler): one, named for the kernel (the
    memset of its tickets is no kernel); the whole call puts as many
    beside the plain per-group sum of its rows."""
    _need_card()
    args = _bwd_args(40, 2, 14, 14, 1024, 1, 5, torch.bfloat16)
    ttp.fused_bn_add_relu_tpool_bwd(*args)
    got = _device_kernels(lambda: ttp._launch_bwd_rows(*args),
                          tmp_path / "bwd.json")
    call = _device_kernels(lambda: ttp.fused_bn_add_relu_tpool_bwd(*args),
                           tmp_path / "call.json")
    want = ttp.bwd_plan(40, 2, 14, 14, 1024, 2,
                        torch.cuda.get_device_properties(
                            0).multi_processor_count)["kernels"]
    assert len(got) == want and all("tpool_fused_bwd_kernel" in k
                                    for k in got), got
    assert sum("tpool_fused_bwd_kernel" in k for k in call) == want, call


def test_cuda_bwd_graph_replay_equals_eager():
    """The backward alone captured in a CUDA graph (its tickets' memset
    and scratch inside) and replayed on new inputs: bit for bit the eager
    call on them."""
    _need_card()
    static = list(_bwd_args(40, 4, 28, 28, 512, 1, 5, torch.bfloat16))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ttp.fused_bn_add_relu_tpool_bwd(*static)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ttp.fused_bn_add_relu_tpool_bwd(*static)
    for seed in (5, 7):
        fresh = _bwd_args(40, 4, 28, 28, 512, 1, 5, torch.bfloat16, seed)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        want = ttp.fused_bn_add_relu_tpool_bwd(*fresh)
        torch.cuda.synchronize()
        for g, w in zip(out, want):
            assert torch.equal(g, w)


def test_bench_tpool_bwd_rows_agree_on_the_card():
    """tools/bench_tpool_bwd.py at batch 2: every kernel row's dy and
    dident equal the planned launch's, its rows' sums within 1e-4."""
    _need_card()
    from adamml_tpu_torch.tools import bench_tpool_bwd

    rows = bench_tpool_bwd.run(torch.device("cuda", 0), batch=2)
    assert {r["stage"] for r in rows} == {"stage1", "stage2", "stage3"}
    for r in rows:
        if r["row"] != "add":
            assert r["dy_dident_equal"] and r["rows_within_1e4"], r


def test_cuda_bwd_build_spills_nothing():
    """Every instantiation of the backward kernel in its build log: no
    spill stores or loads, within the launch bound's 128 registers."""
    _need_card()
    from adamml_tpu_torch.ops.kernels import build

    build.build([ttp.KERNEL_BWD])
    entries = [e for e in build.ptxas_entries(ttp.KERNEL_BWD)
               if "tpool_fused_bwd_kernel" in e["entry"]]
    assert len(entries) == 2, entries
    for e in entries:
        assert e["spill_stores"] == e["spill_loads"] == 0, e
        assert e["registers"] <= 128, e


# train-mode BN (ops/kernels/bn_train.py) at flagship's shapes (18 clips x
# 5 segments x 8 frames: the ResNet-50 stem, layer 1 and layer 4), an odd C
# over two replica groups, and SlowFast 8x8's (64 clips, global moments
# over (N, T, H, W)): the fast stem's C = 8 over 26 M rows, the slow
# pathway's 80 channels after the first fusion, res5's 2048:
# (x shape, R, S, seq_inner)
BN_SHAPES = {
    "stem": ((720, 56, 56, 64), 1, 5, 8),
    "layer1": ((720, 56, 56, 256), 1, 5, 8),
    "layer4": ((90, 7, 7, 2048), 1, 5, 1),
    "odd_C": ((40, 9, 9, 37), 2, 5, 1),
    "slowfast_fast_stem": ((64, 32, 112, 112, 8), 1, 1, 1),
    "slowfast_fast_res2": ((64, 32, 56, 56, 8), 1, 1, 1),
    "slowfast_fuse1": ((64, 8, 56, 56, 80), 1, 1, 1),
    "slowfast_res5": ((64, 8, 7, 7, 2048), 1, 1, 1),
}


def _bn_case(case, dtype, seed=7):
    shape, r, s, si = BN_SHAPES[case]
    return _bn_inputs(tbn.geometry(shape, r, s, si), shape, dtype, seed)


def _bn_inputs(geom, shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = (0.5 + torch.randn(shape, generator=g, device="cuda")
         * (0.5 + torch.rand(c, generator=g, device="cuda"))).to(dtype)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    w = 1 + 0.2 * torch.randn(c, generator=g, device="cuda")
    bias = 0.1 * torch.randn(c, generator=g, device="cuda")
    running = (0.3 * torch.randn(c, generator=g, device="cuda"),
               1 + torch.rand(c, generator=g, device="cuda"))
    return geom, x, dy, w, bias, running


def _within(got, want, bound, what):
    """|got - want| <= bound elementwise (a float32 reordering bound)."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    bad = (got.float() - want.float()).abs() > bound
    assert not bool(bad.any()), (what, float(
        ((got.float() - want.float()).abs() - bound).max()))


def _bn_args(geom):
    from adamml_tpu_torch.models.norm import EPSILON, MOMENTUM
    n = geom.count
    return n / (n - 1), MOMENTUM, EPSILON


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BN_SHAPES)
def test_cuda_bn_kernels_match_plain(case, dtype):
    """Each BN kernel against its plain version on the same inputs: the
    sums of the stats and grad-sums passes within 1e-5 of the sums of
    their terms' magnitudes (float32 in another order); the finalize
    kernels' moments, (a, b), running statistics, parameter gradients and
    dx coefficients within 1e-5 of each output's largest entry; y and dx
    within 1 bf16 ulp in bf16 (in float32, 1e-6 of their terms'
    magnitudes), and so within 1e-6 of those magnitudes in bf16 too where
    the terms cancel."""
    _need_card()
    _bn_kernels_within(*_bn_case(case, dtype), dtype)


def _bn_kernels_within(geom, x, dy, w, bias, running, dtype):
    """test_cuda_bn_kernels_match_plain's checks on these inputs, and the
    kernels' launches they make."""
    unbias, m, eps = _bn_args(geom)
    before = dict(tbn.launch_counts)

    part = tbn.stats(x, geom)
    xf = x.float()
    mag = tbn.plain_stats(xf.abs(), geom)[:, 0]
    _within(part.sum(1), tbn.plain_stats(x, geom)[:, 0], 1e-5 * mag, "sums")

    sums = tbn.slab_views(part)
    run_k = tuple(t.clone() for t in running)
    run_p = tuple(t.clone() for t in running)
    mom, a, b = tbn.finalize(sums, None, w, bias, run_k, geom, unbias, m,
                             eps, tbn.MOMENTS | tbn.AFFINE)
    want = tbn.plain_finalize(sums, None, w, bias, run_p, geom, unbias, m,
                              eps, tbn.MOMENTS | tbn.AFFINE)
    for name, g, v in zip(("mom", "a", "b", "running mean", "running var"),
                          (mom, a, b) + run_k, want + run_p):
        _within(g, v, 1e-5 * float(v.abs().max()), name)

    y = tbn.apply(x, a, b, geom)
    want_y = tbn.plain_apply(x, a, b, geom)
    terms = tbn.plain_apply(xf.abs(), a.abs(), b.abs(), geom)
    if dtype == torch.bfloat16:
        assert bool(((y.float() - want_y.float()).abs()
                     <= torch.maximum(bf16_ulp(want_y), 1e-6 * terms)).all())
    else:
        _within(y, want_y, 1e-6 * terms, "y")

    part = tbn.grad_sums(dy, x, geom)
    dyf = dy.float()
    mag = tbn.plain_grad_sums(dyf.abs(), xf.abs(), geom)[:, 0]
    _within(part.sum(1), tbn.plain_grad_sums(dy, x, geom)[:, 0],
            1e-5 * mag, "grad sums")

    for sums in (tbn.slab_views(part),
                 tuple(t.sum(1, keepdim=True) for t in
                       tbn.slab_views(part))):
        got = tbn.grad_finalize(sums, mom, w, geom, eps)
        want = tbn.plain_grad_finalize(sums, mom, w, geom, eps)
        for name, g, v in zip(("dweight", "dbias", "coef"), got, want):
            for i in range(v.shape[0] if name == "coef" else 1):
                gi, vi = (g[i], v[i]) if name == "coef" else (g, v)
                _within(gi, vi, 1e-5 * float(vi.abs().max()), name)
    coef = got[2]
    for d in (dy, None):
        got = tbn.dx(d, x, coef, geom)
        want = tbn.plain_dx(d, x, coef, geom)
        terms = tbn.plain_dx(None if d is None else dyf.abs(), xf.abs(),
                             coef.abs(), geom).float()
        if dtype == torch.bfloat16:
            assert bool(((got.float() - want.float()).abs() <= torch.maximum(
                bf16_ulp(want), 1e-6 * terms)).all()), d is None
        else:
            _within(got, want, 1e-6 * terms, "dx")
    torch.cuda.synchronize()
    counts = {k: tbn.launch_counts[k] - before[k] for k in tbn.KERNELS}
    assert counts == {"bn_stats": 1, "bn_finalize": 1, "bn_apply": 1,
                      "bn_grad_sums": 1, "bn_grad_finalize": 2, "bn_dx": 2}


def _flagship_bn_calls(phase, batch):
    """Every train-mode BN call of one flagship step of ``phase`` at
    ``batch`` clips, after a warm-up step (``bn_call_hooks``),
    with the BN kernels' launches of that step and the model's state
    before the warm-up and after the step."""
    cfg = flagship_cfg()
    model, _ = build_model(cfg)
    state = TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))
    step = make_adamml_train_step(
        model, flags=(StageFlags.main_phase() if phase == "main"
                      else StageFlags.policy_phase()),
        penalty_type="blockdrop", gammas=10.0, clip_gradient=None)
    target = torch.arange(batch, device="cuda") % cfg.model.num_classes
    start = {k: v.clone() for k, v in model.state_dict().items()}
    args = (1e-3, 1e-2, [1.0, 0.05])
    step(state, example_inputs(cfg, batch=batch, seed=300), target, *args,
         seed=0)
    calls, hooks = bn_call_hooks(model)
    torch.cuda.synchronize()
    before = dict(tbn.launch_counts)
    step(state, example_inputs(cfg, batch=batch, seed=301), target, *args,
         seed=1)
    torch.cuda.synchronize()
    launches = {k: tbn.launch_counts[k] - before[k] for k in tbn.KERNELS}
    for h in hooks:
        h.remove()
    end = {k: v.clone() for k, v in model.state_dict().items()}
    return calls, launches, start, end, dict(model.named_parameters())


@pytest.mark.parametrize("phase", ["main", "policy"])
def test_bn_launches_match_the_steps_bn_calls(phase):
    """A flagship step of each phase at 2 clips (--sync-bn, no process
    group) launches the BN kernels its train-mode BN calls make
    (``bn_launches``); over the warm-up and that step every live parameter
    moves and no frozen one, and both subnets' BN statistics move."""
    _need_card()
    calls, launches, start, end, params = _flagship_bn_calls(phase, 2)
    assert sum(calls.values()) > 0
    assert launches == bn_launches(calls)
    live = f"{phase}_net."
    moved = {k: not torch.equal(start[k], end[k]) for k in params}
    assert all(v for k, v in moved.items() if k.startswith(live)), [
        k for k, v in moved.items() if k.startswith(live) and not v]
    assert not any(v for k, v in moved.items() if not k.startswith(live))
    stats = {k.split("_net.")[0] for k in start
             if k.endswith("running_mean")
             and not torch.equal(start[k], end[k])}
    assert stats == {"main", "policy"}, stats


def test_cuda_bn_kernels_match_plain_at_every_call_of_a_step():
    """The BN kernels at every distinct geometry of the train-mode BN calls
    of one flagship main-phase step at 18 clips (the batch
    chip_smoke.py times them at), bf16: test_cuda_bn_kernels_match_plain's
    checks on each."""
    _need_card()
    calls, _ = bn_calls(torch.device("cuda", 0), BN_BATCH)
    geoms = sorted({key[0] for key in calls}, key=lambda g: (g.n, g.p, g.c))
    assert geoms
    for i, geom in enumerate(geoms):
        shape = (geom.n, geom.p, geom.c)
        _bn_kernels_within(*_bn_inputs(geom, shape, torch.bfloat16, i),
                           torch.bfloat16)


def _bn_step(bn, x, dy, sq, si, return_affine):
    xg = x.clone().requires_grad_(True)
    out = bn(xg, True, return_affine, sq, si)
    outs = out if return_affine else (out,)
    cots = (dy,) if not return_affine else tuple(
        torch.full_like(o, 0.01) * (1 + torch.arange(
            o.numel(), device=o.device).reshape(o.shape) % 7) for o in outs)
    torch.autograd.backward(outs, cots)
    return [o.detach() for o in outs] + [
        xg.grad, bn.weight.grad, bn.bias.grad, bn.running_mean.clone(),
        bn.running_var.clone()]


@pytest.mark.parametrize("return_affine", [False, True],
                         ids=["apply", "return_affine"])
@pytest.mark.parametrize("case", ["stem", "layer4", "odd_C"])
def test_cuda_bn_is_deterministic_and_launches_its_kernels(case,
                                                           return_affine):
    """A train-mode GroupedBatchNorm forward and backward on the card, run
    twice from the same state, gives the same bits; each run launches the
    stats, finalize and (without return_affine) apply kernels forward and
    the (grad sums,) grad finalize and dx kernels backward, once each;
    under sync-BN (no process group: one data shard) the finalize runs in
    its two halves."""
    _need_card()
    from adamml_tpu_torch.models.norm import GroupedBatchNorm

    geom, x, dy, w, bias, running = _bn_case(case, torch.bfloat16, seed=11)
    shape, r, sq, si = BN_SHAPES[case]
    runs = []
    for sync in (False, False, True):
        bn = GroupedBatchNorm(shape[-1], torch.bfloat16, r).cuda()
        bn.sync = sync
        with torch.no_grad():
            bn.weight.copy_(w), bn.bias.copy_(bias)
            bn.running_mean.copy_(running[0]), bn.running_var.copy_(
                running[1])
        before = dict(tbn.launch_counts)
        runs.append(_bn_step(bn, x, dy, sq, si, return_affine))
        torch.cuda.synchronize()
        counts = {k: tbn.launch_counts[k] - before[k] for k in tbn.KERNELS}
        assert counts == {
            "bn_stats": 1, "bn_finalize": 2 if sync else 1,
            "bn_apply": 0 if return_affine else 1,
            "bn_grad_sums": 0 if return_affine else 1,
            "bn_grad_finalize": 1, "bn_dx": 1}, sync
    for a, b, c in zip(*runs):
        assert torch.equal(a, b)
        # the split finalize takes the same sums in the same order
        assert torch.equal(a, c)


def _offset(t):
    """t's values in a contiguous tensor one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.parametrize("operand", ["x", "dy"])
def test_cuda_bn_passes_take_misaligned_operands(operand):
    """A contiguous x or dy that does not start on a 16-byte boundary sends
    the passes that read it by vectors to one channel a thread: their
    outputs match the plain versions as in test_cuda_bn_kernels_match_plain
    (no misaligned-address fault)."""
    _need_card()
    geom, x, dy, w, bias, running = _bn_case("layer4", torch.bfloat16)
    unbias, m, eps = _bn_args(geom)
    if operand == "x":
        x = _offset(x)
    else:
        dy = _offset(dy)
    assert tbn._shape(x, geom, dy)[1]["vec"] == 1
    xf, dyf = x.float(), dy.float()
    part = tbn.stats(x, geom)
    mag = tbn.plain_stats(xf.abs(), geom)[:, 0]
    _within(part.sum(1), tbn.plain_stats(x, geom)[:, 0], 1e-5 * mag, "sums")
    mom, a, b = tbn.finalize(tbn.slab_views(part), None, w, bias, None, geom,
                             unbias, m, eps, tbn.MOMENTS | tbn.AFFINE)
    y = tbn.apply(x, a, b, geom)
    want = tbn.plain_apply(x, a, b, geom)
    assert bool(((y.float() - want.float()).abs() <= torch.maximum(
        bf16_ulp(want), 1e-6 * tbn.plain_apply(xf.abs(), a.abs(), b.abs(),
                                               geom))).all())
    part = tbn.grad_sums(dy, x, geom)
    mag = tbn.plain_grad_sums(dyf.abs(), xf.abs(), geom)[:, 0]
    _within(part.sum(1), tbn.plain_grad_sums(dy, x, geom)[:, 0],
            1e-5 * mag, "grad sums")
    coef = tbn.grad_finalize(tbn.slab_views(part), mom, w, geom, eps)[2]
    got = tbn.dx(dy, x, coef, geom)
    want = tbn.plain_dx(dy, x, coef, geom)
    terms = tbn.plain_dx(dyf.abs(), xf.abs(), coef.abs(), geom).float()
    assert bool(((got.float() - want.float()).abs() <= torch.maximum(
        bf16_ulp(want), 1e-6 * terms)).all())
    torch.cuda.synchronize()


# SlowFast's 3D convolutions (models/layers.py::Conv3d) at 8 clips: the
# fast and slow stems, a lateral connection, the fast res4's temporal conv:
# (x shape (N, T, H, W, C), out channels, kernel, stride)
CONV3D_SHAPES = {
    "fast_stem": ((8, 32, 224, 224, 3), 8, (5, 7, 7), (1, 2, 2)),
    "slow_stem": ((8, 8, 224, 224, 3), 64, (1, 7, 7), (1, 2, 2)),
    "fuse_stem": ((8, 32, 56, 56, 8), 16, (7, 1, 1), (4, 1, 1)),
    "fuse_res4": ((8, 32, 14, 14, 128), 256, (7, 1, 1), (4, 1, 1)),
    "fast_res4_a": ((8, 32, 14, 14, 128), 32, (3, 1, 1), (1, 1, 1)),
}


@pytest.mark.parametrize("case", CONV3D_SHAPES)
def test_conv3d_bf16_channels_last_matches_float32(case):
    """Conv3d in bf16 on (N, T, H, W, C) clips, read and written as
    ``channels_last_3d`` (no layout copy: the output's permute is
    contiguous), against F.conv3d in float32 (TF32 off) on NCDHW copies:
    within 2^-7 of the sum of the terms' magnitudes (each product rounded
    from bf16 operands, 2^-9 each, accumulated in float32)."""
    _need_card()
    from adamml_tpu_torch.models.layers import Conv3d

    shape, cout, kernel, stride = CONV3D_SHAPES[case]
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    conv = Conv3d(shape[-1], cout, kernel, stride, torch.bfloat16).cuda()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g,
                                      device="cuda"))
        got = conv(x)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        xf = x.float().permute(0, 4, 1, 2, 3).contiguous()
        wf = conv.weight.to(torch.bfloat16).float()
        pad = tuple(k // 2 for k in kernel)
        want = torch.nn.functional.conv3d(xf, wf, stride=stride,
                                          padding=pad)
        terms = torch.nn.functional.conv3d(xf.abs(), wf.abs(), stride=stride,
                                           padding=pad)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    want = want.permute(0, 2, 3, 4, 1)
    terms = terms.permute(0, 2, 3, 4, 1)
    assert got.shape == want.shape
    assert bool(((got.float() - want).abs() <= 2 ** -7 * terms).all())


def test_mvit_step_on_the_card_matches_the_cpu():
    """A small MViT (width 8, 4 blocks with transitions at 1 and 3, 4
    frames of 32 px, 2 clips) in float32 with TF32 off: one AdamW train
    step on the card (the pooling's channels-first depthwise convolutions,
    the attention's baddbmm and bmm) against the same step on the CPU,
    logits within 1e-5 of the largest and every leaf's gradient within
    1e-4 of the larger of its largest entry and the median leaf's (the
    sums' order differs, float32 reads about 1e-6). Drop path and the
    head's dropout are off: a CPU and a CUDA generator of one seed draw
    different masks (the CPU tests hold the masks to the reference's)."""
    _need_card()
    from adamml_tpu_torch.models.model_builder import init_model
    from adamml_tpu_torch.models.mvit import MViT
    from adamml_tpu_torch.train.optim import AdamW
    from adamml_tpu_torch.train.steps import (make_unimodal_train_step,
                                              step_generators)

    small = dict(num_classes=5, embed_dim=8, depth=4, transitions=(1, 3),
                 kv_stride=4, frames=4, input_size=32, drop_path=0.0,
                 dropout=0.0)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 4, 32, 32, 3), generator=g)
    target = torch.randint(0, 5, (2,), generator=g)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for dev in ("cpu", "cuda"):
            model = init_model(MViT(**small), seed=3).to(dev)
            with torch.no_grad():
                logits = model(x.to(dev), train=True,
                               generator=step_generators(
                                   torch.device(dev), 11, 0)[1])
            opt = AdamW(model.parameters(), lr=1e-3)
            make_unimodal_train_step(model, clip_gradient=1.0)(
                TrainState(opt, None), x.to(dev), target.to(dev), 1e-3, 11)
            out[dev] = (logits.cpu(), {
                n: opt.state[p]["exp_avg"].cpu() / 0.1
                for n, p in model.named_parameters()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert float((lg - lc).abs().max() / lc.abs().max()) < 1e-5
    scale = {n: float(t.abs().max()) for n, t in gc.items()}
    med = float(np.median(list(scale.values())))
    gaps = {n: float((gg[n] - gc[n]).abs().max()) / max(scale[n], med)
            for n in gc}
    assert max(gaps.values()) < 1e-4, sorted(gaps.items(),
                                              key=lambda t: -t[1])[:3]


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


def test_tiny_forward_on_card_matches_cpu(monkeypatch):
    _tiny_forward(False, monkeypatch)


def test_tiny_dw_forward_on_card_matches_cpu(monkeypatch):
    _tiny_forward(True, monkeypatch)


def _tiny_forward(use_pallas_dw, monkeypatch):
    """Float32, TF32 off: the policy net's logits (both trunks) and the
    main net's under fixed decisions, on the card and on the CPU from the
    same weights, within 1e-3; with use_pallas_dw=True 51 depthwise
    launches, without it none."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = flagship_cfg(tiny=True)
    cfg.model.use_pallas_dw = use_pallas_dw
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
    assert _dw_counts()[0] - before[0] == (51 if use_pallas_dw else 0)
    for got, want in zip(*outs):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


def test_dw_eval_step_puts_at_most_5_more_kernels(tmp_path):
    """The flagship eval step (2 clips) with use_pallas_dw=True puts at
    most 5 more kernels on the card than without it (torch.profiler, after
    a warm-up call): each depthwise layer is one kernel, where cuDNN's
    depthwise convolution puts one or more."""
    _need_card()
    kernels = {}
    for flag in (False, True):
        cfg = flagship_cfg()
        cfg.model.use_pallas_dw = flag
        model, _ = build_model(cfg)
        step = make_adamml_eval_step(model)
        x = example_inputs(cfg, batch=2, seed=100)
        target = torch.zeros(2, dtype=torch.long, device="cuda")
        step(EvalState(), x, target, seed=0)
        kernels[flag] = len(_device_kernels(
            lambda: step(EvalState(), x, target, seed=1),
            tmp_path / f"dw_{flag}.json"))
        del model, step
    assert kernels[True] - kernels[False] <= 5, kernels


# (eval_capacity, capacity_groups)
CAPACITIES = [(1.0, 1), (0.5, 1), (0.25, 1), (0.5, 2)]


def _packed_rows(fn):
    """(the row counts of the forward epilogue's launches in ``fn``, what
    ``fn`` returns): the launcher is wrapped while ``fn`` runs."""
    rows, real = [], ttp._launch

    def launch(y, *args):
        rows.append(int(y.shape[0]))
        return real(y, *args)
    ttp._launch = launch
    try:
        out = fn()
    finally:
        ttp._launch = real
    return rows, out


@pytest.mark.parametrize("capacity,groups", CAPACITIES,
                         ids=[f"c{c}_G{g}" for c, g in CAPACITIES])
def test_eval_capacity_packs_on_the_card(capacity, groups):
    """The tiny config's main net at eval capacity ``capacity`` in
    ``groups`` blocks of its 16 rows, the decisions forced to select at
    most cap rows a block (cap - 1 in the second modality): the forward
    epilogue launches on the packed row count at each stage boundary that
    pools, and the logits lie within 2% of the largest logit of the
    unpacked net's masked logits on the same weights (the backbones on
    fewer rows may take other cuDNN algorithms). The eval step with the
    policy's own decisions gives finite logits, and validate's
    capacity_dropped equals a count made here from its selections."""
    _need_card()
    from adamml_tpu_torch.train.engine import validate

    base_cfg = flagship_cfg(tiny=True)
    base, _ = build_model(base_cfg)
    s, batch = base_cfg.model.num_segments, 8
    rows = batch * s
    pools = sum(base_cfg.model.groups >> i > 1 for i in range(3))
    x = example_inputs(base_cfg, batch=batch, seed=600)
    m_x = [a.reshape((rows,) + tuple(a.shape[2:])) for a in x]
    gen = torch.Generator(device="cuda").manual_seed(601)
    target = torch.randint(0, base_cfg.model.num_classes, (batch,),
                           generator=gen, device="cuda")
    cfg = flagship_cfg(tiny=True)
    cfg.model.eval_capacity, cfg.model.capacity_groups = capacity, groups
    model, _ = build_model(cfg)
    model.load_state_dict(base.state_dict())
    bl = rows // groups
    cap = max(1, int(round(capacity * bl)))
    dec = torch.zeros((2, rows), device="cuda")
    for m in range(2):
        for b in range(groups):
            pick = torch.randperm(bl, generator=gen, device="cuda")[
                :max(1, min(cap, bl) - m)]
            dec[m, b * bl + pick] = 1.0
    with torch.no_grad():
        got_rows, packed = _packed_rows(
            lambda: model.main_net(m_x, dec, seq_groups=s))
        want = base.main_net(m_x, dec, seq_groups=s)
    torch.cuda.synchronize()
    n_run = rows if capacity >= 1.0 else groups * cap
    assert got_rows == [n_run] * pools
    assert bool(torch.isfinite(packed).all())
    assert float((packed - want).abs().max()) <= 0.02 * max(
        float(want.abs().max()), 1.0)

    step = make_adamml_eval_step(model)
    logits, _, _ = step(EvalState(), x, target, seed=0)
    assert bool(torch.isfinite(logits).all())
    batches = [0, 1]
    v = validate(batches, lambda b: (x, target), step, EvalState(),
                 seed=11, modality=["rgb", "sound"], adamml=True,
                 num_segments=s, eval_capacity=capacity,
                 capacity_groups=groups)
    host = [0, 0]
    for sel in np.split(v["all_selections"], len(batches)):
        flat = sel.reshape(rows, 2)
        for m in range(2):
            for b in range(groups):
                on = int(flat[b * bl:(b + 1) * bl, m].sum())
                host[m] += max(0, on - cap) if capacity < 1.0 else 0
    counted = v.get("capacity_dropped", {"rgb": 0, "sound": 0})
    assert [counted["rgb"], counted["sound"]] == host


def _st_zero_noise(generator, logits, tau):
    """Zero-noise straight-through decision: no generator stream, so the
    card and the CPU take the same decisions."""
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


# the crop-resize kernel against the plain path: float32 within 1e-4
# normalised and 5e-3 in raw pixel units (test_crop_resize_normalize_matches'
# reasons, tests/test_torch_data.py); bf16 within one bf16 ulp, plus a tenth
# of the float32 limit where float32 round-off near 0 spans more than one
# bf16 ulp (tests/test_torch_crop_resize.py)
CROP_F32_ATOL = {True: 1e-4, False: 5e-3}
CROP_BF16_ATOL = {True: 1e-5, False: 5e-4}


def _crop_close(got, want, normalize: bool) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        assert within_one_bf16_ulp(got, want, CROP_BF16_ATOL[normalize]), (
            float((got.float() - want.float()).abs().max()))
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=CROP_F32_ATOL[normalize])


def _crop_both(a: dict, dtype) -> tuple:
    """(the kernel's output, the plain path's) of ``a``
    (``tools/crop_cases.py``'s keyword arguments), one launch counted."""
    a = dict(a)
    flow = a.pop("flow")
    before = tcr.launch_counts[tcr.KERNEL]
    got = tcr.crop_resize(**a, flow=flow, out_dtype=dtype)
    torch.cuda.synchronize()
    assert tcr.launch_counts[tcr.KERNEL] == before + 1
    return got, plain_crop_resize(**a, flow_channels=flow,
                                  compute_dtype=dtype)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", cc.STEP_CASES,
                         ids=[c[0] for c in cc.STEP_CASES])
def test_cuda_crop_resize_matches_plain(case, dtype, normalize, monkeypatch):
    """The kernel at each train cell's visual modalities of one step (the
    benchmark's train crops, in the cell's crop mode, on full-size
    canvases; MViT's random-sized crops magnify) against the plain path,
    float32 with TF32 off."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    a = cc.step_inputs(case, "cuda", seed=7)
    if not normalize:
        a["mean"] = a["std"] = None
    _crop_close(*_crop_both(a, dtype), normalize)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ncrops", [1, 3])
@pytest.mark.parametrize("out_size", [8, 48])
@pytest.mark.parametrize("modality", sorted(cc.MODALITIES))
def test_cuda_crop_resize_odd_crops(modality, out_size, ncrops, dtype,
                                    normalize, monkeypatch):
    """The CPU tests' odd crops: minified to 8 px (up to 16 taps an axis),
    magnified to 48, the 3.5-pixel crop, crops across the canvas edge and
    one outside it, flips, three oversample crops a canvas."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    a = cc.odd_inputs(modality, ncrops, out_size, normalize, "cuda")
    _crop_close(*_crop_both(a, dtype), normalize)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_crop_resize_fused_rgbdiff(dtype, monkeypatch):
    """rgbdiff formed per tap equals the rgb kernel over
    rgbdiff_from_frames' uint8 differences, packed five frames an output
    frame, bit for bit; and the plain path's rgbdiff_from_frames followed
    by the resize within the limits."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    a = cc.step_inputs(cc.STEP_CASES[3], "cuda", seed=9)
    flow = a.pop("flow")
    fused = tcr.crop_resize(**a, flow=flow, out_dtype=dtype)
    frames = a.pop("frames")
    n, t = frames.shape[:2]
    diffs = rgbdiff_from_frames(
        frames.reshape((n, t // 6, 6) + tuple(frames.shape[2:])))
    diffs = diffs.reshape((n, t // 6 * 5) + tuple(frames.shape[2:]))
    a["rgbdiff"] = False
    rgb = tcr.crop_resize(diffs, **dict(a, cons=1), flow=flow,
                          out_dtype=dtype)
    packed = rgb.reshape((n, t // 6, 5) + tuple(rgb.shape[2:]))
    packed = packed.permute(0, 1, 3, 4, 2, 5).reshape(fused.shape)
    torch.testing.assert_close(fused, packed, rtol=0, atol=0)
    _crop_close(fused, plain_crop_resize(diffs, **a, flow_channels=flow,
                                         compute_dtype=dtype), True)


@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("case", sorted(cc.AXIS_CASES))
def test_cuda_crop_resize_weights_are_the_tap_rule(case, axis):
    """The kernel's weights along one axis, read through impulse canvases
    (canvas frame j lights canvas column, or row, j; the other axis is one
    pixel, whose one tap weighs 1 exactly, so each output is its weight of
    index j times 255 rounded once), equal crop_resize.band_weights' times
    255 bit for bit, on every output row, column and channel: the tap rule
    written in PyTorch, which the CPU tests hold to resample_weights, is
    the kernel's, beyond its four cached weights too (116 taps at
    464 -> 8)."""
    _need_card()
    in_size, out_size, origin, extent = cc.AXIS_CASES[case]
    eye = torch.eye(in_size, dtype=torch.uint8, device="cuda") * 255
    if axis == "x":
        frames = eye[:, None, :, None].expand(in_size, 1, in_size, 3)
        crop = [origin, 0.0, extent, 1.0]
    else:
        frames = eye[:, :, None, None].expand(in_size, in_size, 1, 3)
        crop = [0.0, origin, 1.0, extent]
    out = tcr.crop_resize(frames.contiguous()[None],
                          torch.tensor([crop], device="cuda"),
                          torch.tensor([False], device="cuda"),
                          out_size=out_size, mean=None, std=None)[0]
    want = tcr.band_weights(in_size, out_size, torch.tensor([origin]),
                            torch.tensor([extent]))[0].T * 255.0
    want = want.cuda()  # (canvas index j, output o)
    if axis == "x":
        want = want[:, None, :, None].expand(out.shape)
    else:
        want = want[:, :, None, None].expand(out.shape)
    assert torch.equal(out, want), float((out - want).abs().max())


@pytest.mark.parametrize("case", cc.STEP_CASES[2:4],
                         ids=[c[0] for c in cc.STEP_CASES[2:4]])
def test_cuda_crop_resize_is_deterministic(case):
    _need_card()
    a = cc.step_inputs(case, "cuda", seed=11)
    flow = a.pop("flow")
    first = tcr.crop_resize(**a, flow=flow, out_dtype=torch.bfloat16)
    again = tcr.crop_resize(**a, flow=flow, out_dtype=torch.bfloat16)
    assert torch.equal(first, again)


def test_crop_resize_launches_once_a_visual_modality():
    """make_batch_preprocessor launches the kernel once a visual modality
    a batch and never for sound, in training and in the oversample eval
    (3 crops folded into the batch); the unimodal preprocessor once."""
    _need_card()
    argv = ("--dataset synthetic --modality rgb flow rgbdiff sound "
            "--groups 2 --frames_per_group 2 --num_segments 2 "
            "--dense_sampling --input_size 32 --audio_length 0.16 "
            "--compute_dtype bfloat16 --num_crops 3 -b 4").split()
    cfg = config_from_args(arg_parser().parse_args(argv))
    cfg.data.canvas_size = (64, 96)
    for train in (True, False):
        ds = cur._make_dataset(cfg, is_train=train, num_clips=2)
        batch = next(iter(cur._make_loader(cfg, ds, is_train=train)))
        before = tcr.launch_counts[tcr.KERNEL]
        x, _ = make_batch_preprocessor(cfg, train=train, num_segments=2,
                                       device="cuda")(batch)
        torch.cuda.synchronize()
        assert tcr.launch_counts[tcr.KERNEL] == before + 3
        rows = 4 * (1 if train else 3)
        assert [tuple(t_.shape) for t_ in x[:3]] == [
            (rows, 2, 2, 32, 32, k) for k in (3, 10, 15)]
        assert all(t_.dtype == torch.bfloat16 and t_.is_contiguous()
                   for t_ in x[:3])
    uni = ("--dataset synthetic --modality rgb --groups 4 "
           "--frames_per_group 1 --num_segments 1 --dense_sampling "
           "--input_size 32 -b 2").split()
    ucfg = config_from_args(arg_parser().parse_args(uni))
    ucfg.data.canvas_size = (64, 96)
    ds = cur._make_dataset(ucfg, is_train=True, num_clips=1)
    batch = next(iter(cur._make_loader(ucfg, ds, is_train=True)))
    before = tcr.launch_counts[tcr.KERNEL]
    x, _ = make_unimodal_preprocessor(ucfg, train=True,
                                      device="cuda")(batch)
    torch.cuda.synchronize()
    assert tcr.launch_counts[tcr.KERNEL] == before + 1
    assert tuple(x.shape) == (2, 4, 32, 32, 3)


def test_cuda_crop_resize_refuses_what_it_does_not_take():
    """A crop or flip left on the CPU beside canvases on the card, float
    canvases and a strided view of them: refused before any launch."""
    _need_card()
    a = cc.odd_inputs("rgb", 1, 8, True, "cuda")
    flow = a.pop("flow")
    before = tcr.launch_counts[tcr.KERNEL]
    bad = [dict(crop_xywh=a["crop_xywh"].cpu()), dict(flip=a["flip"].cpu()),
           dict(frames=a["frames"].float()),
           dict(frames=torch.zeros((9, 2, 40, 128, 3), dtype=torch.uint8,
                                   device="cuda")[:, :, :, ::2])]
    for kw in bad:
        args = dict(a, **kw)
        with pytest.raises(ValueError):
            tcr.crop_resize(args.pop("frames"), args.pop("crop_xywh"),
                            args.pop("flip"), **args, flow=flow)
    assert tcr.launch_counts[tcr.KERNEL] == before


# train_adamml at the tiny settings (4 frames: 2 stage boundaries pool)
TINY_CLI = ("--dataset synthetic --modality rgb sound -d 18 --groups 4 "
            "--num_segments 2 --dense_sampling --val_num_clips 2 -b 8 "
            "--epochs 1 --warmup_epochs 1 --finetune_epochs 1 "
            "--input_size 32 --audio_length 0.16 "
            "--causality_modeling lstm --cost_weights 1.0 0.05 "
            "--compute_dtype float32 --scale_range 36 48 -j 2 --dropout 0 "
            "--lr_scheduler multisteps --lr_steps 1 --seed 5").split()
# the curriculum's passes: warmup, main, policy, validation, finetune,
# validation, as (kind, trains the policy)
CURRICULUM = [("train", False), ("train", False), ("train", True),
              ("val", False), ("train", False), ("val", False)]


def _probe_epochs(monkeypatch) -> list:
    """Wrap the curriculum's train_epoch and validate while a CLI runs:
    each pass's kind, whether it trains the policy (its cost weights), its
    summary, and the epilogue's (forward, backward) launches."""
    epochs = []

    def wrap(kind, fn):
        def run(*args, **kwargs):
            before = (ttp.launch_counts[ttp.KERNEL],
                      ttp.launch_counts[ttp.KERNEL_BWD])
            out = fn(*args, **kwargs)
            epochs.append(dict(
                kind=kind, policy=any(kwargs.get("cost_weights") or []),
                summary=out[1] if kind == "train" else out,
                launches=(ttp.launch_counts[ttp.KERNEL] - before[0],
                          ttp.launch_counts[ttp.KERNEL_BWD] - before[1])))
            return out
        return run

    monkeypatch.setattr(cur, "train_epoch", wrap("train", cur.train_epoch))
    monkeypatch.setattr(cur, "validate", wrap("val", cur.validate))
    return epochs


def _check_epochs(epochs, pools, steps=None, batch=8):
    """Per pass: a finite loss, selection rates in [0, 1], and ``pools``
    forward epilogue launches a forward pass (a train step or a val batch
    of ``batch`` clips), as many backward a step that trains the main net;
    ``steps`` the host-launched steps of a train pass (its batches when
    None)."""
    for i, e in enumerate(epochs):
        s = e["summary"]
        assert np.isfinite(s["loss"]), (i, s["loss"])
        assert all(0.0 <= v <= 1.0 for v in s["selection"].values()), i
        if e["kind"] == "train":
            n = s["num_batch"] if steps is None else steps
            want = (pools * n, 0 if e["policy"] else pools * n)
        else:
            want = (pools * -(-len(s["outputs"]) // batch), 0)
        assert e["launches"] == want, (i, e["kind"], e["launches"], want)


def test_tiny_cli_on_card_matches_cpu(monkeypatch, tmp_path):
    """train_adamml.main at the tiny settings on the card and on the CPU,
    float32, dropout 0, zero-noise decisions, TF32 off: the warmup epoch's
    loss (the same weights and batch) within 1e-3 relative; the
    curriculum's passes in order; every epoch's loss finite and selection
    rates in [0, 1]; the same artifacts; on the card every pass's epilogue
    launches (2 stage boundaries at 4 frames; ``_check_epochs``), none on
    the CPU."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(tpolicy, "gumbel_decision", _st_zero_noise)
    argv = TINY_CLI + ["--synthetic_length", "8"]
    names, epochs = {}, {}
    for dev in ("cuda", "cpu"):
        with monkeypatch.context() as m:
            epochs[dev] = _probe_epochs(m)
            assert train_adamml.main(argv + ["--logdir", str(tmp_path / dev)],
                                     device=dev) == 0
        folder = next(p for p in (tmp_path / dev).iterdir())
        names[dev] = {p.name for p in folder.iterdir()}
    assert names["cuda"] == names["cpu"]
    for dev in ("cuda", "cpu"):
        assert [(e["kind"], e["policy"]) for e in epochs[dev]] == CURRICULUM
    _check_epochs(epochs["cuda"], pools=2)
    _check_epochs(epochs["cpu"], pools=0)
    losses = {dev: [e["summary"]["loss"] for e in ep if e["kind"] == "train"]
              for dev, ep in epochs.items()}
    assert abs(losses["cuda"][0] - losses["cpu"][0]) <= 1e-3 * abs(
        losses["cpu"][0])


def test_multi_step_curriculum_traces_one_replay_a_pass(monkeypatch,
                                                        tmp_path):
    """train_adamml at the tiny settings with --steps_per_dispatch 2
    --eval_capacity 0.5 --profile_dir on 48 videos (6 batches a pass): the
    curriculum's passes in order; a train pass launches from the host the
    epilogue kernels of the first dispatch's 2 single steps and of the
    capture's 2 steps (its replays launch from the graph), a validation
    pass those of each packed batch; and each of the 4 train passes'
    traces (whole dispatches from loader index 2K on) holds one replay of
    K = 2 steps: 2 x 2 forward epilogue kernels, as many backward unless
    the pass trains the policy."""
    _need_card()
    k, pools = 2, 2
    traces = tmp_path / "traces"
    argv = TINY_CLI + ["--synthetic_length", "48", "--steps_per_dispatch",
                       str(k), "--eval_capacity", "0.5", "--profile_dir",
                       str(traces), "--logdir", str(tmp_path / "logs")]
    epochs = _probe_epochs(monkeypatch)
    assert train_adamml.main(argv, device="cuda") == 0
    assert [(e["kind"], e["policy"]) for e in epochs] == CURRICULUM
    assert all(e["summary"]["num_batch"] == 6 for e in epochs
               if e["kind"] == "train")
    _check_epochs(epochs, pools, steps=2 * k)
    files = sorted(traces.glob("*.pt.trace.json"))
    assert len(files) == 4, files
    for path, policy in zip(files, (False, False, True, False)):
        with open(path) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "kernel"]
        got = (sum("tpool_fused_kernel" in n for n in names),
               sum("tpool_fused_bwd_kernel" in n for n in names))
        assert got == (k * pools, 0 if policy else k * pools), (path, got)


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


def _train_snapshot(model, state):
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            [{p: {k: v.clone() for k, v in st.items()}
              for p, st in opt.state.items()}
             for opt in (state.main_opt, state.policy_opt)], state.step)


def _train_restore(model, state, snap):
    model.load_state_dict(snap[0])
    for opt, saved in zip((state.main_opt, state.policy_opt), snap[1]):
        for p, st in opt.state.items():
            for k, v in st.items():
                v.copy_(saved[p][k])
    state.step = snap[2]


def _replay_vs_single_steps(phase: str, use_pallas_dw: bool,
                            sync_bn: bool = True, trace=None):
    """The tiny float32 config, K = 2: the first dispatch runs 2 single
    steps, the second captures the CUDA graph and replays it; from the
    snapshot between them 2 calls of make_adamml_train_step (the plain
    single step that K = 1 runs) leave the same parameters, BN statistics,
    optimizer state, step and metrics, bit for bit. Later dispatches
    replay; new optimizers run single steps again (the curriculum's stage
    boundaries). With ``trace`` (a path), the third dispatch, a replay, is
    profiled there and the names of its kernels returned."""
    cfg = flagship_cfg(tiny=True)
    cfg.model.use_pallas_dw = use_pallas_dw
    cfg.runtime.sync_bn = sync_bn
    model, _ = build_model(cfg)
    state = TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))
    kw = dict(flags=(StageFlags.main_phase() if phase == "main"
                     else StageFlags.policy_phase()),
              penalty_type="blockdrop", gammas=10.0, clip_gradient=None)
    multi = make_adamml_multi_step(model, **kw)
    single = make_adamml_train_step(model, **kw)

    def batches(seed):
        xs = [example_inputs(cfg, batch=4, seed=seed + i) for i in range(2)]
        return ([torch.stack([x[m] for x in xs]) for m in range(2)],
                torch.arange(8, device="cuda").reshape(2, 4) % 5)

    args = (1e-3, 1e-2, [1.0, 0.05])
    multi(state, *batches(10), *args, 3)
    snap = _train_snapshot(model, state)
    got_m = multi(state, *batches(20), *args, 4)
    assert (multi.eager_dispatches, multi.replays) == (1, 1)
    got = _train_snapshot(model, state)
    _train_restore(model, state, snap)
    xs, ts = batches(20)
    ms = [single(state, [x[s] for x in xs], ts[s], *args, 4)
          for s in range(2)]
    want_m = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
    want = _train_snapshot(model, state)
    assert got[2] == want[2] == snap[2] + 2
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    for a, b in zip(got[1], want[1]):
        for p in b:
            for k in b[p]:
                assert torch.equal(a[p][k], b[p][k]), k
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), k
    xs, ts = batches(30)
    names = None
    if trace is None:
        multi(state, xs, ts, *args, 5)
    else:
        names = _device_kernels(lambda: multi(state, xs, ts, *args, 5),
                                trace)
    assert (multi.eager_dispatches, multi.replays) == (1, 2)
    state.main_opt = build_optimizer("main", cfg.optim,
                                     model.main_net.parameters())
    state.policy_opt = build_optimizer("policy", cfg.optim,
                                       model.policy_net.parameters())
    multi(state, *batches(40), *args, 6)
    assert (multi.eager_dispatches, multi.replays) == (2, 2)
    return names


@pytest.mark.parametrize("phase", ["main", "policy"])
def test_multi_step_replay_equals_eager(phase, monkeypatch):
    """A replay equals the same K steps run as single steps
    (``_replay_vs_single_steps``). cuDNN deterministic: at these float32
    shapes its default algorithms sum in an order that changes from run to
    run, so two runs of the single steps would differ too."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _replay_vs_single_steps(phase, use_pallas_dw=False)


@pytest.mark.parametrize("phase", ["main", "policy"])
def test_multi_step_replay_with_depthwise_kernel(phase, monkeypatch,
                                                 tmp_path):
    """As above with use_pallas_dw=True: the depthwise kernel (and in the
    policy phase the trunks' remat) under capture. A replay of K = 2 steps
    puts on the card (torch.profiler) K times one step's epilogue kernels
    (forward at each stage boundary that pools, backward too in the main
    phase) and its depthwise kernels (DW_STEP, forward and stride-1 input
    gradient)."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    names = _replay_vs_single_steps(phase, use_pallas_dw=True,
                                    trace=tmp_path / "replay.json")
    k = 2
    pools = sum(flagship_cfg(tiny=True).model.groups >> i > 1
                for i in range(3))
    got = (sum("tpool_fused_kernel" in n for n in names),
           sum("tpool_fused_bwd_kernel" in n for n in names),
           sum("dw3x3_kernel" in n for n in names))
    assert got == (k * pools, k * pools if phase == "main" else 0,
                   k * sum(DW_STEP[phase])), got


class _SlowSamples:
    """A dataset whose every sample takes ``seconds`` to fetch."""

    def __init__(self, ds, seconds):
        self.ds, self.seconds = ds, seconds
        self.modality = ds.modality

    def __len__(self):
        return len(self.ds)

    def get_sample(self, index, rng=None):
        time.sleep(self.seconds)
        return self.ds.get_sample(index, rng)


class _NoCard:
    def available(self):
        return False


def _pinned_loader(batches, *, seconds=0.0, prefetch=2, canvas=(64, 96)):
    """(a loader whose batches come in page-locked buffers from torch's
    caching host allocator, the same loader's batches as new numpy
    arrays)."""
    out = []
    for pinned in (None, _NoCard()):
        ds = SyntheticVideoDataset(["rgb", "sound"], length=4 * batches,
                                   num_groups=4, frames_per_group=2,
                                   num_clips=2, num_classes=7,
                                   canvas_size=canvas, audio_length=0.16,
                                   is_train=True, dense_sampling=True, seed=9)
        ld = HostDataLoader(_SlowSamples(ds, seconds), 4, is_train=True,
                            input_size=32, scale_range=(64, 80), workers=2,
                            seed=11, prefetch=prefetch)
        if pinned is not None:
            ld.pinned = pinned
        out.append(ld)
    return out[0], list(out[1])


def _counts(*names):
    got = profiling.counters()
    return [got.get(n, {"count": 0})["count"] for n in names]


NAMES = ("data.h2d.direct", "data.h2d.staged", "data.pinned_alloc")


def _host_blocks():
    """Page-locked blocks torch's caching host allocator has made (its
    statistics are empty until it makes one)."""
    return torch.cuda.host_memory_stats().get("num_host_alloc", 0)


def test_pinned_buffers_reused_only_after_their_copies():
    """The stream held (``torch.cuda._sleep``) before each copy, so that
    the loader runs ahead of the card, and each batch dropped once its
    large arrays are enqueued; the host waits for the card every fourth
    batch, as a dispatch does. Every copy on the card holds its batch's
    bytes, though the allocator reused its blocks (fewer made than the 16
    batches' buffers); every frames and wave array went straight from its
    page-locked buffer (``data.h2d.direct``), none through a staged copy,
    and the loader asked for one batch's buffers a batch."""
    _need_card()
    ld, want = _pinned_loader(16)
    before, blocks = _counts(*NAMES), _host_blocks()
    copies = []
    for i, batch in enumerate(ld):
        for k in ld._large:
            torch.cuda._sleep(10_000_000)
            copies.append(to_device(batch[k], torch.device("cuda")))
        del batch
        if i % 4 == 3:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    direct, staged, allocs = (a - b for a, b in zip(_counts(*NAMES), before))
    got = iter(copies)
    for w in want:
        for k in ld._large:
            assert next(got).cpu().numpy().tobytes() == w[k].tobytes(), k
    assert (direct, staged, allocs) == (16 * len(ld._large), 0, 16)
    assert _host_blocks() - blocks < 16 * len(ld._large)


@pytest.mark.parametrize("where", ["side-stream", "second-card"])
def test_pinned_buffer_reuse_waits_for_a_copy_on_another_stream(where):
    """Each batch copied on a stream other than the current one, held
    (``torch.cuda._sleep``) before the copy, then dropped: a side stream of
    the current card, or the current stream of a second card while the
    current device stays the first (as a run on ``cuda:1`` without
    ``set_device``). Every copy holds its batch's bytes: the allocator
    orders a block's reuse after the stream the copy ran on."""
    _need_card()
    if where == "second-card" and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", 0 if where == "side-stream" else 1)
    side = torch.cuda.Stream()

    def copy(x):
        if where == "side-stream":
            with torch.cuda.stream(side):
                torch.cuda._sleep(10_000_000)
                return to_device(x, dev)
        with torch.cuda.device(dev):   # the second card's current stream
            torch.cuda._sleep(10_000_000)
        assert torch.cuda.current_device() == 0
        return to_device(x, dev)

    ld, want = _pinned_loader(16)
    copies = []
    for batch in ld:
        copies += [copy(batch[k]) for k in ld._large]
        del batch
    torch.cuda.synchronize(dev)
    got = iter(copies)
    for w in want:
        for k in ld._large:
            assert next(got).cpu().numpy().tobytes() == w[k].tobytes(), k


def test_pinned_buffers_for_a_consumer_holding_every_batch():
    """``list(loader)`` holds every batch: a buffer each at least, all
    intact, and each copied to the card intact after the pass."""
    _need_card()
    ld, want = _pinned_loader(12)
    before = _counts(*NAMES)
    kept = list(ld)
    assert _counts(*NAMES)[2] - before[2] == 12
    for got, w in zip(kept, want):
        for k in w:
            assert got[k].tobytes() == w[k].tobytes(), k
    copies = []
    for got in kept:
        torch.cuda._sleep(10_000_000)
        copies.append([to_device(got[k], torch.device("cuda"))
                       for k in ld._large])
    torch.cuda.synchronize()
    for c, w in zip(copies, want):
        for d, k in zip(c, ld._large):
            assert d.cpu().numpy().tobytes() == w[k].tobytes(), k


def test_multi_step_capture_while_the_loader_fills(monkeypatch):
    """The K = 2 graph captures and replays while the loader's threads
    fetch and fill page-locked buffers (those handed to the producer at
    the batches taken before), and a replay still equals the eager steps;
    at least one batch was filled while the steps ran, and the batches
    taken after them are intact."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ld, want = _pinned_loader(24, seconds=0.05, prefetch=6, canvas=(256, 464))
    it = iter(ld)
    first = [next(it) for _ in range(9)]
    del first
    torch.cuda.synchronize()
    got = [next(it)]   # its take hands the producer one more buffer
    filled = _counts("data.collate")[0]
    t0 = time.perf_counter()
    _replay_vs_single_steps("main", use_pallas_dw=False)
    assert time.perf_counter() - t0 > 0.2
    assert _counts("data.collate")[0] > filled
    got += list(it)
    for g, w in zip(got, want[9:]):
        for k in w:
            assert g[k].tobytes() == w[k].tobytes(), k


@pytest.fixture
def group_of_one(request, tmp_path):
    """A process group of one on cuda:0 in this process (``request.param``:
    the backend), left at the end."""
    _need_card()
    from adamml_tpu_torch.parallel import mesh

    cfg = flagship_cfg(tiny=True)
    cfg.runtime.dist_url = mesh.file_url(tmp_path)
    got = mesh.init_distributed(cfg, "cuda:0", backend=request.param,
                                timeout_s=60)
    try:
        yield got
    finally:
        mesh.shutdown()


def _tiny_step_state(phase, sync_bn):
    """One tiny float32 step from the seeded init (real noise): the
    metrics and the state dict."""
    cfg = flagship_cfg(tiny=True)
    cfg.runtime.sync_bn = sync_bn
    model, _ = build_model(cfg)
    state = TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))
    step = make_adamml_train_step(
        model, flags=(StageFlags.main_phase() if phase == "main"
                      else StageFlags.policy_phase()),
        penalty_type="blockdrop", gammas=10.0, clip_gradient=None)
    x = example_inputs(cfg, batch=4, seed=7)
    m = step(state, x, torch.arange(4, device="cuda") % 5, 1e-3, 1e-2,
             [1.0, 0.05], seed=2)
    return m, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("group_of_one", ["nccl"], indirect=True)
@pytest.mark.parametrize("sync_bn", [False, True],
                         ids=["per_replica_bn", "sync_bn"])
@pytest.mark.parametrize("phase", ["main", "policy"])
def test_nccl_group_of_one_is_the_single_process(phase, sync_bn,
                                                 group_of_one, monkeypatch):
    """World size 1 under NCCL: the gradient all-reduce, the metric
    average and the BN broadcast (or the synchronized moments) run, and the
    step equals the one without a group, bit for bit (cuDNN
    deterministic)."""
    from adamml_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    assert (group_of_one.world, group_of_one.backend) == (1, "nccl")
    got_m, got = _tiny_step_state(phase, sync_bn)
    mesh.shutdown()
    want_m, want = _tiny_step_state(phase, sync_bn)
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), k
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("group_of_one", ["nccl"], indirect=True)
@pytest.mark.parametrize("phase,sync_bn", [("main", False),
                                           ("policy", True)])
def test_nccl_replay_holds_the_collectives(phase, sync_bn, group_of_one,
                                           monkeypatch):
    """The K = 2 replay in an NCCL group of one, its collectives captured
    in the graph (the main phase with per-replica BN: gradients, metrics,
    BN statistics; the policy phase under --sync-bn: the moments in the
    forward and backward), equals K single steps bit for bit
    (``_replay_vs_single_steps``)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _replay_vs_single_steps(phase, use_pallas_dw=False, sync_bn=sync_bn)


@pytest.mark.parametrize("group_of_one", ["gloo"], indirect=True)
def test_gloo_refuses_a_captured_graph(group_of_one):
    """Gloo's collectives run on the host, where no CUDA graph can hold
    them: K steps a dispatch on a CUDA model raise instead of running K
    single steps."""
    model, _ = build_model(flagship_cfg(tiny=True))
    with pytest.raises(ValueError, match="gloo"):
        make_adamml_multi_step(model, flags=StageFlags.main_phase(),
                               penalty_type="blockdrop", gammas=10.0,
                               clip_gradient=None)


@pytest.mark.parametrize("sync_bn", [False, True],
                         ids=["per_replica_bn", "sync_bn"])
def test_two_ranks_share_the_card(sync_bn, tmp_path):
    """Two processes on cuda:0 over gloo, the tiny flagship's main and
    policy steps on 4 rows each of a global 8: both ranks bit-identical,
    each launching the fused epilogue's kernels at its 2 stage boundaries
    that pool (forward in both steps, backward in the main step), and
    within tests/test_torch_multiprocess.py's tolerances of the single
    process at bn_groups 2 (1 under --sync-bn), cuDNN deterministic."""
    _need_card()
    from test_torch_multiprocess import LR, P_LR_K, _launch, check_compare

    results, _ = _launch(tmp_path, "steps", device="cuda:0", sync_bn=sync_bn,
                         batch=8, lr=LR, p_lr=P_LR_K, rtol=1e-4)
    assert results[0]["digests"] == results[1]["digests"]
    assert results[0]["synced"] is results[1]["synced"] is sync_bn
    for r in results:
        assert (r["launches"][ttp.KERNEL],
                r["launches"][ttp.KERNEL_BWD]) == (4, 2), r["launches"]
    for i, c in enumerate(results[0]["compare"]):
        check_compare(c, i)


def test_bench_update_rows_agree_on_the_card():
    """bench_update's per_tensor and vector rows leave the foreach row's
    parameters and state: the vector row bit for bit (the same _foreach
    kernels over one tensor), the per_tensor row bit for bit or within
    1e-6 of each tensor's largest value (other kernels, which may contract
    another multiply-add); each row timed, traced and bounded."""
    _need_card()
    from adamml_tpu_torch.tools import bench_update

    rows = bench_update.run(torch.device("cuda", 0), tiny=True, iters=20,
                            warmup=2)
    for r in rows:
        if "agreement" in r:
            for k, a in r["agreement"]["vector"].items():
                assert a["bitwise"], (r["optimizer"], k, a)
            for k, a in r["agreement"]["per_tensor"].items():
                assert a["bitwise"] or a["max_rel_diff"] <= 1e-6, (k, a)
        else:
            assert r["ms"] > 0 and r["launches_per_update"] > 0
            assert 0 < r["share_of_bound"] < 1.5


def test_mem_analysis_main_phase_on_the_card():
    """--phase main --batch 2: a peak above the step's arguments, and the
    fused epilogue's 3 forward and 3 backward launches in the step."""
    _need_card()
    from adamml_tpu_torch.tools import mem_analysis

    r = mem_analysis.run(torch.device("cuda", 0), phase="main", batch=2)
    assert r["peak_bytes"] > r["arguments_bytes"] > 0
    assert r["arguments"]["optimizer_state"] > 0
    assert r["launches"] == {ttp.KERNEL: 3, ttp.KERNEL_BWD: 3}
    assert len(r["top_blocks"]) == mem_analysis.TOP


@pytest.mark.parametrize("phase,fused", [("policy", 1), ("main", 0),
                                         ("policy", 0)])
def test_mem_analysis_launches_on_the_card(phase, fused):
    """--batch 2 in the other phase and with --fused_tpool 0: a peak above
    the step's arguments, and the fused epilogue's launches in the step (3
    forward and, in the main phase, 3 backward; none unfused)."""
    _need_card()
    from adamml_tpu_torch.tools import mem_analysis

    r = mem_analysis.run(torch.device("cuda", 0), phase=phase, batch=2,
                         fused_tpool=fused)
    assert r["peak_bytes"] > r["arguments_bytes"] > 0
    want = (3 * fused, 3 * fused if phase == "main" else 0)
    assert (r["launches"][ttp.KERNEL], r["launches"][ttp.KERNEL_BWD]) == want


def test_bench_tpool_rows_agree_on_the_card():
    """tools/bench_tpool.py at batch 2: the prototype kernel's rows within
    one bf16 ulp of its plain version at the three stage shapes."""
    _need_card()
    from adamml_tpu_torch.tools import bench_tpool

    rows = bench_tpool.run(torch.device("cuda", 0), batch=2)
    kernel = [r for r in rows if r["row"] == "kernel"]
    assert [r["stage"] for r in kernel] == ["stage1", "stage2", "stage3"]
    assert all(r["within_1ulp_of_plain"] for r in kernel), kernel


@pytest.mark.parametrize("phase", ["main", "policy"])
def test_capture_map_labels_the_replayed_kernels(phase, tmp_path,
                                                 monkeypatch):
    """The tiny config's K = 2 graph, captured with its capture map
    (utils/profiling.py): the map holds as many kernel nodes as the same
    steps captured without spans, with the same names; a replay in a
    profiler trace runs those kernels one to one in the map's order
    (a copy node the driver runs as a kernel passed over); the kernels
    labelled ``model.bn`` are the six BN kernels (ops/kernels/bn_train.py),
    each of them there, and elementwise kernels (the parameters' gradient
    accumulation); and a replay stays bit-equal to K single steps
    (``_replay_vs_single_steps``, with the map in)."""
    _need_card()
    from benchmark import spans
    from benchmark.trace import STRETCH, Trace, kernel_class

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _replay_vs_single_steps(phase, use_pallas_dw=False)
    cfg = flagship_cfg(tiny=True)
    model, _ = build_model(cfg)
    state = TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))
    multi = make_adamml_multi_step(
        model, flags=(StageFlags.main_phase() if phase == "main"
                      else StageFlags.policy_phase()),
        penalty_type="blockdrop", gammas=10.0, clip_gradient=None)

    def batches(seed):
        xs = [example_inputs(cfg, batch=4, seed=seed + i) for i in range(2)]
        return ([torch.stack([x[m] for x in xs]) for m in range(2)],
                torch.arange(8, device="cuda").reshape(2, 4) % 5)

    args = (1e-3, 1e-2, [1.0, 0.05])
    multi(state, *batches(10), *args, 3)
    multi(state, *batches(20), *args, 4)
    cmap = multi.capture
    assert profiling.CAPTURES[-1] is cmap and cmap["k"] == 2
    assert "model.bn" in cmap["labels"]
    assert len(cmap["labels"]) == len(cmap["names"]) == cmap["kernels"]

    plain = torch.cuda.CUDAGraph()
    for pair in multi.gens:
        for gen in pair:
            plain.register_generator_state(gen)
    with torch.cuda.graph(plain):
        ms = [multi.body(state, [x[s] for x in multi.inputs],
                         multi.targets[s], multi.temperature,
                         multi.cost_weights, *multi.gens[s])
              for s in range(2)]
        _ = {n: torch.stack([m[n] for m in ms]) for n in ms[0]}
        _, kinds, names = profiling.captured_nodes()
    del plain
    assert kinds.count(profiling.KERNEL_NODE) == cmap["kernels"]
    assert names == cmap["names"]

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(STRETCH):
            multi(state, *batches(30), *args, 5)
            torch.cuda.synchronize()
    path = str(tmp_path / "replay.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = Trace(json.load(f)["traceEvents"], 2, 2)
    got = spans.labelled_replays(trace)
    assert got is not None and len(got) == 1
    assert len(got[0]) == cmap["kernels"]
    bn = [e["name"] for e, label in got[0] if label == "model.bn"]
    assert {_bn_kernel_of(n) for n in bn} - {None} == set(tbn.KERNELS)
    assert {kernel_class(n) for n in bn
            if _bn_kernel_of(n) is None} <= {"elementwise"}


def _bn_kernel_of(name):
    """Which of bn_train's kernels a device kernel's name is, or None."""
    for k in tbn.KERNELS:
        if re.search(rf"\b{k}_kernel\b", name):
            return k
    return None
