#!/usr/bin/env python3
"""Time each hand-written CUDA kernel of the PyTorch/CUDA port
(adamml_tpu_torch) alone on one NVIDIA card: the numbers of PERF.md's
kernel table.

    python3 chip_smoke.py

Phases, each printing one JSON line a case:

  device      card name, count, and nvidia-smi's name and power limit;
  build       nvcc builds every CUDA kernel from csrc/ (one process per
              source, all at once) and prints ptxas' registers, shared
              memory, spills;
  kernel      the fused epilogue's forward at the three flagship stage
              boundaries: 8 clips x 5 segments = 40 rows (eval affine,
              R = S = 1), then on the packed rows of eval capacity 0.5
              and 0.25 (N = 20 and 10);
  kernel_bwd  its backward at the three stage boundaries in training
              (R = 1, S = 5), with the kernel's registers, spills, blocks
              an SM, blocks and partials bytes per stage;
  bn_kernel   train-mode BN's six kernels (ops/kernels/bn_train.py) at
              every distinct train-mode BN call of one flagship main-phase
              step at 18 clips, summed over the step's calls, and their
              registers;
  kernel_dw   the depthwise kernel at every distinct layer of one flagship
              eval forward with use_pallas_dw=True (8 clips; the layers
              from a forward hook), timed alone (kernel_ms: the C entry
              with its arguments bound outside the timed span) and as the
              whole call (call_ms), beside cuDNN's depthwise convolution
              (library_ms), per layer and summed by stride; then the
              step's 51 layers back to back in one CUDA-event window;
  tools       the stage-boundary prototype kernel at bench_tpool's shapes;
  crop_resize the card preprocessing's kernel (ops/kernels/crop_resize.py)
              at each train cell's visual modalities of one step (flagship
              rgb, rgbflow rgb, flow and rgbdiff, slowfast rgb;
              tools/crop_cases.py), with the loader's train crops, beside
              the plain path; sums by cell; then its launches on
              make_batch_preprocessor of a rgbflow and a flagship batch;
  kernels     one object per kernel, as in PERF.md's table, with its
              launches on each path the script runs.

Every timed kernel: CUDA events, mean of 20 after 3 warm-up (a plain
version 5 after 1 where it is slow), L2 zeroed between launches, bf16,
beside its plain version and its bound; and its largest absolute error
against its plain version on the same inputs, which must lie within the
card tests' tolerance (the forward epilogue, dy, dident and depthwise bit
for bit; da and db within 1e-4 of their largest entry; the prototype
within one bf16 ulp; BN within test_cuda_bn_kernels_match_plain's
bounds; crop-resize within one bf16 ulp plus 1e-5), or the script stops
with an error. The kernels' launches are counted on the two full-width
steps the script runs to find its shapes (an 18-clip main-phase step, an
8-clip eval step with use_pallas_dw) and on the preprocessing of a rgbflow
and a flagship train batch at full width, counts zeroed just before each,
and must be what those paths launch. The epilogue's bounds are
benchmark/reference/work.py's; bn_work, dw_work and crop_resize.work
count the others. The sums over the three stage boundaries are the
table's "Kernel ms", "Bound ms" and "Plain ms". The port's other checks
on the card are tests/test_torch_gpu.py's:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Then nvidia-smi's name and power limit, and last
{"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import inspect
import json
import sys
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.configs.config import arg_parser, config_from_args
from adamml_tpu_torch.data.device_pipeline import make_batch_preprocessor
from adamml_tpu_torch.models.mobilenet_v2 import _DepthwiseConv
from adamml_tpu_torch.models.model_builder import build_model, example_inputs
from adamml_tpu_torch.models.norm import EPSILON, MOMENTUM, GroupedBatchNorm
from adamml_tpu_torch.ops.augment import plain_crop_resize
from adamml_tpu_torch.ops.kernels import bn_train as tbn
from adamml_tpu_torch.ops.kernels import build
from adamml_tpu_torch.ops.kernels import crop_resize as crk
from adamml_tpu_torch.ops.kernels import depthwise as dwk
from adamml_tpu_torch.ops.kernels import tpool_fused as tp
from adamml_tpu_torch.ops.kernels import tpool_proto as tpp
from adamml_tpu_torch.ops.spectrogram import SpectrogramConfig
from adamml_tpu_torch.tools import bench_tpool
from adamml_tpu_torch.tools import crop_cases as cc
from adamml_tpu_torch.tools.timing import (HBM_BYTES_PER_S, bf16_ulp,
                                           bound_ms, event_ms,
                                           l2_flush_buffer, nvidia_smi,
                                           within_one_bf16_ulp)
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.steps import (make_adamml_eval_step,
                                          make_adamml_train_step)
from adamml_tpu_torch.train.train_state import (EvalState, StageFlags,
                                                TrainState)
from benchmark.reference.work import tpool_bwd_work, tpool_work

# the train step's settings (bench.py:156-161)
LR, P_LR, COST, GAMMAS = 1e-3, 1e-2, [1.0, 0.05], 10.0
COUNTS = (tp.launch_counts, dwk.launch_counts, tpp.launch_counts,
          tbn.launch_counts, crk.launch_counts)
BWD_NAME = "tpool_fused_bwd_kernel"
TIMING = ("CUDA events, mean of 20 after 3 warm-up, L2 zeroed between "
          "launches")
PLAIN_TIMING = TIMING + "; plain: mean of 5 after 1"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def zero_counts() -> None:
    for counts in COUNTS:
        for k in counts:
            counts[k] = 0


def all_counts() -> dict:
    return {k: v for counts in COUNTS for k, v in counts.items()}


def max_abs_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def bit_equal(label: str, got, want) -> float:
    """``got`` equals ``want`` bit for bit; its largest error (0)."""
    check(got.dtype == want.dtype and torch.equal(got, want),
          f"{label}: differs from the plain version by "
          f"{max_abs_err(got, want)}")
    return 0.0


def _sum(rows) -> dict:
    """The rows' kernel, plain and bound ms summed, and the sums' share."""
    out = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


# (F, H, W, C) of the three flagship stage boundaries that pool over time
STAGES = [(8, 56, 56, 256), (4, 28, 28, 512), (2, 14, 14, 1024)]


def kernel_phase(dev) -> dict:
    """The forward kernel against its plain version at each stage boundary
    on N = 40 rows (an 8-clip eval step) and on the packed row counts of
    eval capacity 0.5 and 0.25 (N = 20 and 10): timings, bound, largest
    error. Returns per N the stages' rows and their sums."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = l2_flush_buffer(dev)
    res = {}
    for n in (40, 20, 10):
        rows = []
        for stage, (f, h, w, c) in enumerate(STAGES, 1):
            y, ident = (torch.randn((n, f, h, w, c), generator=gen,
                                    device=dev).to(torch.bfloat16)
                        for _ in range(2))
            a = 1.0 + 0.3 * torch.randn((1, 1, c), generator=gen, device=dev)
            b = 0.1 * torch.randn((1, 1, c), generator=gen, device=dev)
            err = bit_equal(f"forward N{n} stage {stage}",
                            tp.fused_bn_add_relu_tpool(y, ident, a, b),
                            tp.reference_impl(y, ident, a, b))
            nbytes, ops = tpool_work(n, f, h, w, c, 2)
            bound, by = bound_ms(nbytes, ops)
            k_ms = event_ms(lambda: tp.fused_bn_add_relu_tpool(
                y, ident, a, b), flush=flush)
            p_ms = event_ms(lambda: tp.reference_impl(y, ident, a, b),
                            flush=flush)
            row = dict(case=f"N{n}_stage{stage}", shape=[n, f, h, w, c],
                       dtype="bfloat16", max_abs_err=err, ms=k_ms,
                       plain_ms=p_ms, bound_ms=bound, bound_by=by,
                       bytes=nbytes, ops=ops, share_of_bound=bound / k_ms)
            emit("kernel", **row, timing=TIMING)
            rows.append(row)
            del y, ident
        res[f"N{n}"] = dict(_sum(rows), stages=rows, max_abs_err=max(
            r["max_abs_err"] for r in rows))
    return res


# (label, N, F, H, W, C, R, S, dtype, timed): the three flagship stage
# boundaries in training (8 clips x 5 segments = 40 rows, one group per
# segment: R = 1, S = 5), timed here; then float32, odd frame counts and
# R = 2, whose plans tests/test_torch_tpool_bwd_plan.py checks on the CPU
BWD_CASES = [
    ("stage1", 40, 8, 56, 56, 256, 1, 5, torch.bfloat16, True),
    ("stage2", 40, 4, 28, 28, 512, 1, 5, torch.bfloat16, True),
    ("stage3", 40, 2, 14, 14, 1024, 1, 5, torch.bfloat16, True),
    ("f32_S2", 8, 8, 14, 14, 128, 1, 2, torch.float32, False),
    ("oddF3", 10, 3, 9, 9, 32, 1, 5, torch.bfloat16, False),
    ("oddF5_f32", 6, 5, 12, 12, 48, 2, 3, torch.float32, False),
    ("R2_S5", 40, 4, 7, 7, 64, 2, 5, torch.bfloat16, False),
]


def bwd_ptxas() -> dict:
    """The backward kernel's instantiations from its build log, by dtype:
    registers, spills, stack and static shared memory."""
    got = {}
    for e in build.ptxas_entries(tp.KERNEL_BWD):
        if BWD_NAME in e["entry"]:
            dtype = "bfloat16" if "bfloat16" in e["entry"] else "float32"
            got[dtype] = {k: e[k] for k in ("registers", "spill_stores",
                                            "spill_loads", "stack", "smem")}
    return got


def blocks_per_sm(registers: int, smem: int, threads: int) -> int:
    """Resident blocks an H100 SM holds of a kernel: its 65,536 registers
    (allocated 256 a warp at a time), its 233,472 bytes of shared memory
    (1,024 of them reserved per block) and 2,048 threads."""
    warps = -(-threads // 32)
    regs = -(-registers * 32 // 256) * 256 * warps
    return min(65536 // regs, 233472 // (smem + 1024), 2048 // threads)


def kernel_bwd_phase(dev) -> dict:
    """The backward kernel against reference_bwd at the three stage
    boundaries in training: timings, bound, dy's and dident's largest
    error, da's and db's largest error over their largest entry (float32
    sums taken in another order), and per stage the registers, blocks an
    SM, blocks and partials bytes of the launch's plan."""
    gen = torch.Generator(device=dev).manual_seed(10)
    flush = l2_flush_buffer(dev)
    regs = bwd_ptxas()["bfloat16"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for label, n, f, h, w, c, r, s, dtype, timed in BWD_CASES:
        if not timed:
            continue
        y, ident = (torch.randn((n, f, h, w, c), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
        a = 1.0 + 0.3 * torch.randn((r, s, c), generator=gen, device=dev)
        b = 0.1 * torch.randn((r, s, c), generator=gen, device=dev)
        ct = torch.randn((n, (f - 1) // 2 + 1, h, w, c), generator=gen,
                         device=dev).to(dtype)
        got = tp.fused_bn_add_relu_tpool_bwd(y, ident, a, b, ct)
        want = tp.reference_bwd(y, ident, a, b, ct)
        errs = [bit_equal(f"{label} {what}", g, w_) for what, g, w_ in
                zip(("dy", "dident"), got, want)]
        dab_rel = max(max_abs_err(g, w_) / max(float(w_.abs().max()), 1e-30)
                      for g, w_ in zip(got[2:], want[2:]))
        check(dab_rel <= 1e-4, f"{label}: da/db off by {dab_rel} of their "
              "largest entry")
        plan = tp.bwd_plan(n, f, h, w, c, y.element_size(), sms)
        nbytes, ops = tpool_bwd_work(n, f, h, w, c, y.element_size())
        bound, by = bound_ms(nbytes, ops)
        k_ms = event_ms(lambda: tp.fused_bn_add_relu_tpool_bwd(
            y, ident, a, b, ct), flush=flush)
        p_ms = event_ms(lambda: tp.reference_bwd(y, ident, a, b, ct),
                        iters=5, warmup=1, flush=flush)
        row = dict(case=label, shape=[n, f, h, w, c], R=r, S=s,
                   dtype="bfloat16", max_abs_err=max(errs),
                   dab_max_rel_err=dab_rel, ms=k_ms, plain_ms=p_ms,
                   bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops,
                   share_of_bound=bound / k_ms,
                   registers=regs["registers"],
                   spill_bytes=regs["spill_stores"] + regs["spill_loads"],
                   blocks_per_sm=blocks_per_sm(
                       regs["registers"], plan["smem_bytes"] + regs["smem"],
                       plan["threads"]),
                   blocks=plan["blocks"],
                   partials_bytes=plan["partials_bytes"],
                   partials_share_of_bound_bytes=plan["partials_bytes"]
                   / nbytes)
        emit("kernel_bwd", **row, timing=PLAIN_TIMING)
        rows.append(row)
        del y, ident, a, b, ct, got, want
    torch.cuda.empty_cache()
    return dict(_sum(rows), stages=rows, ptxas=bwd_ptxas(),
                max_abs_err=max(r["max_abs_err"] for r in rows),
                dab_max_rel_err=max(r["dab_max_rel_err"] for r in rows))


# the benchmark's flagship batch a card
BN_BATCH = 18


_BN_FORWARD = inspect.signature(GroupedBatchNorm.forward)


def bn_call_hooks(model) -> tuple:
    """Pre-hooks on every GroupedBatchNorm of ``model`` that count its
    train-mode calls, as ({(geometry, return_affine, backward, input
    gradient, sync): calls}, hooks). A forward recomputed under remat
    (``update_stats`` off, models/remat.py) fills the first forward's saved
    tensors and has no backward of its own."""
    calls = Counter()

    def record(mod, args, kwargs):
        arg = _BN_FORWARD.bind(mod, *args, **kwargs)
        arg.apply_defaults()
        a = arg.arguments
        if not a["train"]:
            return
        x = a["x"]
        bwd = bool(mod.update_stats and torch.is_grad_enabled() and (
            x.requires_grad or mod.weight.requires_grad))
        calls[(mod.geometry(x, a["seq_groups"], a["seq_inner"]),
               bool(a["return_affine"]), bwd, bwd and x.requires_grad,
               bool(mod.sync))] += 1

    hooks = [m.register_forward_pre_hook(record, with_kwargs=True)
             for m in model.modules() if isinstance(m, GroupedBatchNorm)]
    return calls, hooks


def bn_launches(calls) -> dict:
    """The BN kernels' launches that ``calls`` (``bn_call_hooks``) make:
    stats and finalize (twice under sync-BN) and, but with return_affine,
    apply forward; grad sums (but with return_affine), grad finalize and,
    where x takes a gradient, dx backward."""
    out = dict.fromkeys(tbn.KERNELS, 0)
    for (_, affine, bwd, dx, sync), k in calls.items():
        out["bn_stats"] += k
        out["bn_finalize"] += 2 * k if sync else k
        out["bn_apply"] += 0 if affine else k
        out["bn_grad_sums"] += k if bwd and not affine else 0
        out["bn_grad_finalize"] += k if bwd else 0
        out["bn_dx"] += k if dx else 0
    return out


def bn_calls(dev, batch: int) -> tuple:
    """Every train-mode BN call of one flagship main-phase step at
    ``batch`` clips (after a warm-up step), as ``bn_call_hooks`` counts
    them, and the kernels' launches of that step, counts zeroed just
    before: the epilogue's 3 forward and 3 backward, no depthwise, and the
    BN kernels its calls make (``bn_launches``), or an error."""
    cfg = flagship_cfg()
    model, _ = build_model(cfg)
    state = TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))
    step = make_adamml_train_step(model, flags=StageFlags.main_phase(),
                                  penalty_type="blockdrop", gammas=GAMMAS,
                                  clip_gradient=None)
    target = torch.randint(0, cfg.model.num_classes, (batch,), device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(3))
    step(state, example_inputs(cfg, batch=batch, seed=300), target, LR,
         P_LR, COST, seed=0)
    inputs = example_inputs(cfg, batch=batch, seed=301)
    calls, hooks = bn_call_hooks(model)
    torch.cuda.synchronize()
    zero_counts()
    step(state, inputs, target, LR, P_LR, COST, seed=1)
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_counts().items() if v}
    for h in hooks:
        h.remove()
    del model, state, step
    torch.cuda.empty_cache()
    want = {tp.KERNEL: 3, tp.KERNEL_BWD: 3, **{
        k: v for k, v in bn_launches(calls).items() if v}}
    check(launches == want, f"one {batch}-clip main-phase step launched "
          f"{launches}, expected {want}")
    return calls, launches


def bn_work(geom, itemsize: int, affine: bool, bwd: bool,
            input_grad: bool) -> dict:
    """The least bytes each BN pass moves: every element of x (and dy)
    read once and of y (and dx) written once; 0 for the finalize kernels,
    which read only the partials."""
    n = geom.n * geom.p * geom.c * itemsize
    work = {"bn_stats": n, "bn_finalize": 0}
    if not affine:
        work["bn_apply"] = 2 * n
    if bwd:
        if not affine:
            work["bn_grad_sums"] = 2 * n
        work["bn_grad_finalize"] = 0
        if input_grad:
            work["bn_dx"] = 2 * n if affine else 3 * n
    return work


def _bn_fns(geom, x, dy, w, bias, affine: bool) -> tuple:
    """({kernel: (its call, its plain version's call)}, {kernel: largest
    error against the plain version on the same inputs}), each error first
    checked against tests/test_torch_gpu.py::_bn_kernels_within's bound:
    the stats and grad sums within 1e-5 of their terms' magnitudes; the
    finalize kernels' outputs (and each dx coefficient) within 1e-5 of
    their largest entry; y and dx within one bf16 ulp or 1e-6 of their
    terms' magnitudes. The finalize kernels run on the stats pass's sums
    (and, with ``affine``, on (a, b) standing for the epilogue's
    gradients); dx without its dy term with ``affine``."""
    args = (geom.count / (geom.count - 1), MOMENTUM, EPSILON,
            tbn.MOMENTS | tbn.AFFINE)
    errs = {}

    def run():
        return (torch.zeros(geom.c, device=x.device),
                torch.ones(geom.c, device=x.device))

    def within(name, got, want, bound, ulp=False):
        err = (got.float() - want.float()).abs()
        tol = torch.maximum(bf16_ulp(want), bound) if ulp else bound
        over = float((err - tol).max())
        check(got.shape == want.shape and over <= 0,
              f"{name} at {geom} (return_affine={affine}) differs from its "
              f"plain version by {over} past its tolerance")
        errs[name] = max(errs.get(name, 0.0), float(err.max()))

    def within_max(name, got, want):
        within(name, got, want, 1e-5 * float(want.abs().max()))

    xf, dyf = x.float(), dy.float()
    timed_run = run()
    sums = tbn.slab_views(tbn.stats(x, geom))
    psums = tbn.slab_views(tbn.plain_stats(x, geom))
    within("bn_stats", tbn.stats(x, geom).sum(1),
           tbn.plain_stats(x, geom)[:, 0],
           1e-5 * tbn.plain_stats(xf.abs(), geom)[:, 0])
    run_k, run_p = run(), run()
    got = tbn.finalize(sums, None, w, bias, run_k, geom, *args)
    want = tbn.plain_finalize(sums, None, w, bias, run_p, geom, *args)
    for g, v in zip(got + run_k, want + run_p):
        within_max("bn_finalize", g, v)
    mom, a, b = got
    fns = {"bn_stats": (lambda: tbn.stats(x, geom),
                        lambda: tbn.plain_stats(x, geom)),
           "bn_finalize": (
               lambda: tbn.finalize(sums, None, w, bias, timed_run, geom,
                                    *args),
               lambda: tbn.plain_finalize(psums, None, w, bias, timed_run,
                                          geom, *args))}
    if affine:
        gsums = pgsums = tuple(t.reshape(geom.g, 1, geom.c) for t in (a, b))
    else:
        gsums = tbn.slab_views(tbn.grad_sums(dy, x, geom))
        pgsums = tbn.slab_views(tbn.plain_grad_sums(dy, x, geom))
        fns["bn_apply"] = (lambda: tbn.apply(x, a, b, geom),
                           lambda: tbn.plain_apply(x, a, b, geom))
        fns["bn_grad_sums"] = (lambda: tbn.grad_sums(dy, x, geom),
                               lambda: tbn.plain_grad_sums(dy, x, geom))
        within("bn_apply", tbn.apply(x, a, b, geom),
               tbn.plain_apply(x, a, b, geom),
               1e-6 * tbn.plain_apply(xf.abs(), a.abs(), b.abs(), geom),
               ulp=True)
        within("bn_grad_sums", tbn.grad_sums(dy, x, geom).sum(1),
               tbn.plain_grad_sums(dy, x, geom)[:, 0],
               1e-5 * tbn.plain_grad_sums(dyf.abs(), xf.abs(), geom)[:, 0])
    got = tbn.grad_finalize(gsums, mom, w, geom, EPSILON)
    want = tbn.plain_grad_finalize(gsums, mom, w, geom, EPSILON)
    for g, v in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        within_max("bn_grad_finalize", g, v)
    coef = got[2]
    d, df = (None, None) if affine else (dy, dyf.abs())
    fns["bn_grad_finalize"] = (
        lambda: tbn.grad_finalize(gsums, mom, w, geom, EPSILON),
        lambda: tbn.plain_grad_finalize(pgsums, mom, w, geom, EPSILON))
    fns["bn_dx"] = (lambda: tbn.dx(d, x, coef, geom),
                    lambda: tbn.plain_dx(d, x, coef, geom))
    within("bn_dx", tbn.dx(d, x, coef, geom), tbn.plain_dx(d, x, coef, geom),
           1e-6 * tbn.plain_dx(df, xf.abs(), coef.abs(), geom).float(),
           ulp=True)
    return fns, errs


def bn_kernel_phase(dev) -> dict:
    """The six BN kernels at every distinct train-mode BN call of one
    flagship main-phase step (BN_BATCH clips), each timed with CUDA events
    (L2 zeroed between launches) beside its byte bound and its plain
    version's time, with its largest error against the plain version
    (``_bn_fns``); sums over the step weighted by the calls, and the
    step's launches (``bn_calls``)."""
    calls, launches = bn_calls(dev, BN_BATCH)
    flush = l2_flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "calls": 0,
               "max_abs_err": 0.0} for k in tbn.KERNELS}
    for (geom, affine, bwd, input_grad, _), k in sorted(
            calls.items(), key=lambda kv: -kv[0][0].n * kv[0][0].p
            * kv[0][0].c):
        shape = (geom.n, geom.p, geom.c)
        x = (0.5 + torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        w = 1 + 0.2 * torch.randn(geom.c, generator=gen, device=dev)
        bias = 0.1 * torch.randn(geom.c, generator=gen, device=dev)
        fns, errs = _bn_fns(geom, x, dy, w, bias, affine)
        pl = tbn.plan(geom, tbn.vec_width(geom.c, 2), sms)
        line = dict(shape=list(shape), R=geom.r, S=geom.s, si=geom.si,
                    return_affine=affine, backward=bwd, calls=k,
                    plan={q: pl[q] for q in ("vec", "tcg", "lanes", "ns", "k",
                                             "slab", "blocks",
                                             "partials_bytes")})
        for name, nbytes in bn_work(geom, 2, affine, bwd, input_grad).items():
            kern, plain = fns[name]
            err = errs[name]
            k_ms = event_ms(kern, flush=flush)
            p_ms = event_ms(plain, iters=5, warmup=1, flush=flush)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            line[name] = dict(kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                              share_of_bound=b_ms / k_ms if b_ms else None,
                              max_abs_err=err)
            t = tot[name]
            t["ms"] += k * k_ms
            t["plain_ms"] += k * p_ms
            t["bound_ms"] += k * b_ms
            t["calls"] += k
            t["max_abs_err"] = max(t["max_abs_err"], err)
        emit("bn_kernel", **line)
        del x, dy, fns
    for t in tot.values():
        t["share_of_bound"] = t["bound_ms"] / t["ms"] if t["ms"] else None
    res = dict(_sum(tot.values()), per_kernel=tot,
               calls_per_step=sum(calls.values()), step_launches=launches,
               max_abs_err={k: t["max_abs_err"] for k, t in tot.items()},
               ptxas=build.ptxas_entries(tbn.SOURCE))
    emit("bn_kernel_sum", batch_clips=BN_BATCH, **res,
         timing=PLAIN_TIMING + "; sums weighted by the calls of one "
                               "main-phase step")
    return res


def dw_work(x_shape, stride, itemsize, tap_itemsize, affine=False):
    """(bytes, float32 ops) of one depthwise call as the kernel reads it: x
    read once, out written once, the taps once in their own dtype, and the
    float32 scale and bias only when an affine is given; 18 operations (9
    multiplies, 9 adds) per output element."""
    b, h, w, c = x_shape
    oh, ow = dwk.same_pads(h, stride)[0], dwk.same_pads(w, stride)[0]
    nbytes = ((b * h * w * c + b * oh * ow * c) * itemsize
              + 9 * c * tap_itemsize + (8 * c if affine else 0))
    return nbytes, 18 * b * oh * ow * c


def _dw_inputs(shape, gen, dev):
    """bf16 x and the taps as _DepthwiseConv passes them (a (3, 3, C) view
    of a (C, 1, 3, 3) weight in x's dtype)."""
    x = (2.0 * torch.randn(shape, generator=gen, device=dev)).to(
        torch.bfloat16)
    weight = 0.3 * torch.randn((shape[-1], 1, 3, 3), generator=gen,
                               device=dev)
    return x, weight.to(torch.bfloat16)[:, 0].permute(1, 2, 0)


def _cudnn_dw(x, taps, stride):
    """One PyTorch call for the same function (cuDNN's depthwise
    convolution on the channels_last view); at stride 2 the SAME padding
    is asymmetric, so F.pad comes first: two calls."""
    c = x.shape[-1]
    wc = taps.permute(2, 0, 1)[:, None].contiguous()  # (C, 1, 3, 3)
    if stride == 1:
        return lambda: F.conv2d(x.permute(0, 3, 1, 2), wc, padding=1,
                                groups=c)
    _, ph_lo, ph_hi = dwk.same_pads(x.shape[1], stride)
    _, pw_lo, pw_hi = dwk.same_pads(x.shape[2], stride)
    return lambda: F.conv2d(F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
                            .permute(0, 3, 1, 2), wc, stride=stride,
                            groups=c)


def dw_layers(batch: int = 8) -> tuple:
    """(input shape, stride) of every depthwise layer of one flagship eval
    step with use_pallas_dw=True, in the step's order (a forward hook on
    each _DepthwiseConv), and the kernels' launches of that step, counts
    zeroed just before: the epilogue's 3 forward and 51 depthwise, or an
    error."""
    cfg = flagship_cfg()
    cfg.model.use_pallas_dw = True
    model, _ = build_model(cfg)
    order = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: order.append((tuple(args[0].shape),
                                             mod.strides)))
        for m in model.modules() if isinstance(m, _DepthwiseConv)]
    target = torch.zeros(batch, dtype=torch.long, device="cuda")
    inputs = example_inputs(cfg, batch=batch, seed=100)
    torch.cuda.synchronize()
    zero_counts()
    make_adamml_eval_step(model)(EvalState(), inputs, target, seed=0)
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_counts().items() if v}
    for h in hooks:
        h.remove()
    del model
    torch.cuda.empty_cache()
    want = {tp.KERNEL: 3, dwk.KERNEL: 51}
    check(launches == want and len(order) == 51, f"one {batch}-clip eval "
          f"step launched {launches} over {len(order)} depthwise layers, "
          f"expected {want}")
    return order, launches


def kernel_dw_phase(dev) -> dict:
    """The depthwise kernel at every distinct (input shape, stride) of one
    eval forward (bf16, identity affine, no clip), against reference_impl,
    timed as the kernel alone, as the whole ``depthwise_conv3x3`` call, as
    the plain version and as cuDNN; sums weight each layer by its count in
    the step, over all layers and by stride. Then the step's layers back to
    back in one CUDA-event window, with no L2 flush between them (as a step
    runs them; the L2 zeroed before each window): against the per-layer sum
    this shows how much of each launch's fixed cost a step pays."""
    gen = torch.Generator(device=dev).manual_seed(20)
    flush = l2_flush_buffer(dev)
    order, launches = dw_layers()
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "library_ms", "layers")
    res = {"max_abs_err": 0.0, **dict.fromkeys(keys, 0.0),
           "s1": dict.fromkeys(keys, 0.0), "s2": dict.fromkeys(keys, 0.0),
           "step_launches": launches}
    bound_by = Counter()
    for (shape, stride), count in sorted(Counter(order).items()):
        x, taps = _dw_inputs(shape, gen, dev)
        with torch.no_grad():
            err = bit_equal(f"depthwise {shape} s{stride}",
                            dwk.depthwise_conv3x3(x, taps, stride=stride),
                            dwk.reference_impl(x, taps, None, None, stride,
                                               False))
            nbytes, ops = dw_work(shape, stride, 2, taps.element_size())
            bound, by = bound_ms(nbytes, ops)
            launch, _ = dwk.bind(x, taps, None, None, stride, False)
            k_ms = event_ms(launch, flush=flush)
            c_ms = event_ms(lambda: dwk.depthwise_conv3x3(x, taps,
                                                          stride=stride),
                            flush=flush)
            p_ms = event_ms(lambda: dwk.reference_impl(
                x, taps, None, None, stride, False), iters=5, warmup=1,
                flush=flush)
            l_ms = event_ms(_cudnn_dw(x, taps, stride), flush=flush)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        bound_by[by] += count
        for key, v in (("ms", k_ms), ("call_ms", c_ms), ("plain_ms", p_ms),
                       ("bound_ms", bound), ("library_ms", l_ms),
                       ("layers", 1)):
            res[key] += count * v
            res[f"s{stride}"][key] += count * v
        plan = dwk.tile_plan(*shape, stride, 2)
        emit("kernel_dw", case="flagship", shape=list(shape), stride=stride,
             dtype="bfloat16", calls_per_eval_step=count, max_abs_err=err,
             kernel_ms=k_ms, call_ms=c_ms, plain_ms=p_ms, bound_ms=bound,
             bound_by=by, bytes=nbytes, ops=ops,
             achieved_GBps=nbytes / k_ms / 1e6, share_of_bound=bound / k_ms,
             library_ms=l_ms,
             library="F.conv2d(groups=C) on the channels_last view" + (
                 "" if stride == 1 else ", after F.pad (two calls)"),
             tile=dict(th=plan.th, tw=plan.tw, cb=plan.cb, vec=plan.vec,
                       threads=plan.threads, smem_bytes=plan.smem_bytes,
                       tiles=plan.tiles),
             timing=PLAIN_TIMING)
        del x, taps, launch
    for r in (res, res["s1"], res["s2"]):
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["library_over_kernel"] = r["library_ms"] / r["ms"]
    res["bound_by"] = dict(bound_by)
    for case in ("s1", "s2"):
        emit("kernel_dw", case=f"sum_stride{case[1]}", **res[case])

    # back to back: each layer bound outside the timed span
    bound = {key: dwk.bind(*_dw_inputs(key[0], gen, dev), None, None,
                           key[1], False) for key in dict.fromkeys(order)}
    launches = [bound[key][0] for key in order]

    def window():
        for launch in launches:
            launch()

    res["back_to_back_ms"] = event_ms(window, flush=flush)
    emit("kernel_dw", case="sum_all", **{k: v for k, v in res.items()
                                         if k not in ("s1", "s2")},
         back_to_back_share_of_bound=res["bound_ms"] / res["back_to_back_ms"],
         timing=PLAIN_TIMING + "; back to back: all the layers of one eval "
                               "step in its order in one window")
    del bound, launches
    torch.cuda.empty_cache()
    return res


# the bf16 output against the plain path's: one bf16 ulp, plus a tenth of
# the float32 limit (1e-4 normalised) where round-off near 0 spans more
CROP_BF16_ATOL = 1e-5
# rgbflow's preprocessing (benchmark/configs/rgbflow.json's flags for it)
RGBFLOW_ARGV = ("--dataset kinetics-sounds --modality rgb flow rgbdiff "
                "--groups 8 --frames_per_group 4 --num_segments 5 "
                "--dense_sampling -b 9").split()


def preprocess_launches(dev) -> dict:
    """The kernel's launches on its main path: ``make_batch_preprocessor``
    of rgbflow (rgb, flow, rgbdiff) and of flagship (rgb, sound) at full
    width, each on one train batch of STEP_CASES' canvases from the host,
    counts zeroed just before the call; one launch a visual modality and
    none for sound, and the model's input shapes, or an error."""
    out = {}
    for cell, cfg in (
            ("rgbflow", config_from_args(arg_parser().parse_args(
                RGBFLOW_ARGV))),
            ("flagship", flagship_cfg())):
        cases = [c for c in cc.STEP_CASES if c[0].startswith(cell)]
        n, s = cases[0][2], cfg.model.num_segments
        batch = {"target": np.zeros(n, np.int64)}
        for i, case in enumerate(cases):
            a = cc.step_inputs(case, dev, seed=60 + i)
            m = case[1]
            batch[f"{m}_frames"] = a["frames"].cpu().numpy()
            batch[f"{m}_crop"] = a["crop_xywh"].cpu().numpy()
            batch[f"{m}_flip"] = a["flip"].cpu().numpy()
            del a
        if "sound" in cfg.model.modality:
            length = SpectrogramConfig(
                resampling_rate=int(cfg.data.resampling_rate),
                audio_length=cfg.data.audio_length).num_samples
            batch["sound_wave"] = np.zeros((n, s, length), np.float32)
            batch["sound_valid"] = np.ones((n, s), np.float32)
        preprocess = make_batch_preprocessor(cfg, train=True, num_segments=s,
                                             device=dev)
        torch.cuda.synchronize()
        zero_counts()
        inputs, _ = preprocess(batch)
        torch.cuda.synchronize()
        got = {k: v for k, v in all_counts().items() if v}
        check(got == {crk.KERNEL: len(cases)},
              f"{cell} preprocessing: {got} launches for {len(cases)} "
              f"visual modalities")
        shapes = [list(x.shape) for x in inputs]
        check(all(x[:2] == [n, s] for x in shapes),
              f"{cell} preprocessing: input shapes {shapes}")
        out[cell] = got
        emit("crop_resize", case=f"{cell}_preprocess", launches=got,
             inputs=shapes)
        del batch, inputs
        torch.cuda.empty_cache()
    return out


def crop_resize_phase(dev) -> dict:
    """The crop-resize kernel at each crop_cases.STEP_CASES row, bf16:
    timed with CUDA events (L2 zeroed between launches) beside the plain
    path (augment.plain_crop_resize, float32 with TF32 off, one rounding to
    bf16) and the bound (crop_resize.work: the canvas bytes under the taps'
    support read once and the output written once, over 3.35 TB/s), with
    its largest error against the plain path, which must lie within one
    bf16 ulp (plus CROP_BF16_ATOL); sums by cell; then its launches on the
    preprocessing (``preprocess_launches``)."""
    flush = l2_flush_buffer(dev)
    rows = []
    for i, case in enumerate(cc.STEP_CASES):
        a = cc.step_inputs(case, dev, seed=40 + i)
        flow = a.pop("flow")
        zero_counts()
        got = crk.crop_resize(**a, flow=flow, out_dtype=torch.bfloat16)
        check(crk.launch_counts[crk.KERNEL] == 1,
              f"crop_resize {case[0]}: {crk.launch_counts} launches")
        want = plain_crop_resize(**a, flow_channels=flow,
                                 compute_dtype=torch.bfloat16)
        err = max_abs_err(got, want)
        check(within_one_bf16_ulp(got, want, CROP_BF16_ATOL),
              f"crop_resize {case[0]}: beyond one bf16 ulp of the plain "
              f"path ({err})")
        del got, want
        nbytes = crk.work(tuple(a["frames"].shape), a["crop_xywh"],
                          a["out_size"], a["cons"], a["rgbdiff"], 2)
        bound, by = bound_ms(nbytes, 0)
        k_ms = event_ms(lambda: crk.crop_resize(
            **a, flow=flow, out_dtype=torch.bfloat16), flush=flush)
        p_ms = event_ms(lambda: plain_crop_resize(
            **a, flow_channels=flow, compute_dtype=torch.bfloat16),
            iters=5, warmup=1, flush=flush)
        row = dict(case=case[0], canvases=list(a["frames"].shape),
                   cons=a["cons"], rgbdiff=a["rgbdiff"], dtype="bfloat16",
                   max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                   bound_by=by, bytes=nbytes, share_of_bound=bound / k_ms)
        emit("crop_resize", **row, timing=PLAIN_TIMING)
        rows.append(row)
        del a
        torch.cuda.empty_cache()
    cells = {}
    for cell in ("flagship", "rgbflow", "slowfast"):
        mine = [r for r in rows if r["case"].startswith(cell)]
        cells[cell] = dict(_sum(mine), max_abs_err=max(
            r["max_abs_err"] for r in mine))
    res = dict(cells=cells, cases=rows,
               ptxas=build.ptxas_entries(crk.SOURCE),
               preprocess=preprocess_launches(dev))
    emit("crop_resize_sum", cells=cells, timing=PLAIN_TIMING)
    return res


def tools_phase(dev) -> dict:
    """The prototype kernel (tools/bench_tpool.py's) against its plain
    version at bench_tpool's three stage shapes (batch 8)."""
    flush = l2_flush_buffer(dev)
    rows = []
    for shape, stage in bench_tpool.shapes(8):
        y, ident, a, b = bench_tpool.inputs(shape, dev)
        nbytes, ops = tpool_work(*shape, 2)
        bound, by = bound_ms(nbytes, ops)
        got = tpp.tpool_proto(y, ident, a, b)
        want = tpp.reference_impl(y, ident, a, b)
        check(within_one_bf16_ulp(got, want), f"prototype {stage}: beyond "
              f"one bf16 ulp of the plain version ({max_abs_err(got, want)})")
        k_ms = event_ms(lambda: tpp.tpool_proto(y, ident, a, b), flush=flush)
        row = dict(case=stage, shape=list(shape), dtype="bfloat16",
                   max_abs_err=max_abs_err(got, want),
                   ms=k_ms, bound_ms=bound, bound_by=by,
                   share_of_bound=bound / k_ms,
                   plain_ms=event_ms(lambda: tpp.reference_impl(
                       y, ident, a, b), flush=flush))
        emit("tools", **row, timing=TIMING)
        rows.append(row)
        del y, ident, got, want
    return dict(_sum(rows), stages=rows,
                max_abs_err=max(r["max_abs_err"] for r in rows))


def _table(res) -> dict:
    """The table's entries of a kernel phase's result."""
    return {k: res[k] for k in ("ms", "plain_ms", "bound_ms",
                                "share_of_bound", "max_abs_err")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit("device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    kernels = [tp.KERNEL, tp.KERNEL_BWD, dwk.KERNEL, tpp.KERNEL, tbn.SOURCE,
               crk.SOURCE]
    t0 = time.perf_counter()
    build.build(kernels)
    ptxas = {k: [ln.strip() for ln in build.build_log(k).splitlines()
                 if "Used" in ln or "spill" in ln] for k in kernels}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    kres = kernel_phase(dev)
    bres = kernel_bwd_phase(dev)
    bnres = bn_kernel_phase(dev)
    dres = kernel_dw_phase(dev)
    ores = tools_phase(dev)
    cres = crop_resize_phase(dev)
    # each kernel's launches a step, by path: an 8-clip eval step with
    # use_pallas_dw, an 18-clip main-phase step, and the preprocessing of a
    # rgbflow and of a flagship train batch
    paths = {"eval_step": dres["step_launches"],
             "main_step": bnres["step_launches"],
             "rgbflow_preprocess": cres["preprocess"]["rgbflow"],
             "flagship_preprocess": cres["preprocess"]["flagship"]}

    def launches(name):
        return {path: got.get(name, 0) for path, got in paths.items()}

    print(json.dumps({"kernels": [{
        "name": tp.KERNEL, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/tpool_fused.cu",
        "replaces": "adamml_tpu/ops/pallas/tpool_fused.py:71",
        "also_replaces": ["adamml_tpu/ops/pallas/tpool_fused.py:345"],
        "launches": launches(tp.KERNEL), "library_ms": None,
        **_table(kres["N40"]), "bound_by": kres["N40"]["stages"][0][
            "bound_by"],
        "per_stage_ms": [r["ms"] for r in kres["N40"]["stages"]],
        "packed_rows": {k: _table(kres[k]) for k in ("N20", "N10")},
        "note": "ms, plain_ms and bound_ms are sums over the three "
                "flagship stage boundaries of one 8-clip eval step "
                "(packed_rows: the same at N = 20 and 10)"}, {
        "name": tp.KERNEL_BWD, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/tpool_fused_bwd.cu",
        "replaces": "adamml_tpu/ops/pallas/tpool_fused.py:92",
        "also_replaces": ["adamml_tpu/ops/pallas/tpool_fused.py:402"],
        "launches": launches(tp.KERNEL_BWD), "library_ms": None,
        **_table(bres), "bound_by": bres["stages"][0]["bound_by"],
        "dab_max_rel_err": bres["dab_max_rel_err"],
        "per_stage": bres["stages"], "ptxas": bres["ptxas"],
        "note": "ms, plain_ms and bound_ms are sums over the three "
                "flagship stage boundaries of one 8-clip main-phase step "
                "(per_stage: each boundary, with the kernel's registers, "
                "blocks an SM and partials bytes); max_abs_err is dy's and "
                "dident's"}, {
        "name": dwk.KERNEL, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/depthwise.cu",
        "replaces": "adamml_tpu/ops/pallas/depthwise.py:78",
        "launches": launches(dwk.KERNEL),
        **_table(dres), "call_ms": dres["call_ms"],
        "library_ms": dres["library_ms"], "bound_by": dres["bound_by"],
        "stride1": dres["s1"], "stride2": dres["s2"],
        "back_to_back_ms": dres["back_to_back_ms"],
        "note": "ms (the kernel alone), call_ms (depthwise_conv3x3 as "
                "the model calls it), plain_ms, bound_ms and library_ms "
                "are sums over the 51 depthwise layers of one 8-clip eval "
                "step with use_pallas_dw=True (library: cuDNN's depthwise "
                "convolution, F.pad first at stride 2)"}, {
        "name": tpp.KERNEL, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/tpool_proto.cu",
        "replaces": "tools/bench_tpool.py:53",
        "launches": None, "library_ms": None,
        **_table(ores), "bound_by": ores["stages"][0]["bound_by"],
        "note": "ms, plain_ms and bound_ms are sums over bench_tpool's "
                "three stage shapes at batch 8; no step launches it"}, {
        "name": tbn.SOURCE, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/bn_train.cu",
        "replaces": None,
        "kernels": list(tbn.KERNELS),
        "launches": {k: launches(k) for k in tbn.KERNELS},
        "calls_per_step": {k: t["calls"]
                           for k, t in bnres["per_kernel"].items()},
        **_table(bnres), "bound_by": "bytes", "library_ms": None,
        "note": "no Pallas kernel: the JAX package leaves train-mode BN "
                "to XLA; ms, plain_ms and bound_ms are sums over the BN "
                "calls of one 18-clip flagship main-phase step (the "
                "finalize kernels count no bound bytes); max_abs_err is "
                "each kernel's largest over those calls' shapes (sums' "
                "errors scale with the sums)"}, {
        "name": crk.KERNEL, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/crop_resize.cu",
        "replaces": None, "launches": launches(crk.KERNEL),
        "library_ms": None, "bound_by": "bytes",
        **_table(cres["cells"]["rgbflow"]), "cells": cres["cells"],
        "ptxas": cres["ptxas"],
        "note": "no Pallas kernel: the JAX package leaves the resize to "
                "XLA; ms, plain_ms and bound_ms are rgbflow's three "
                "modalities of one 9-clip step (cells: each train cell's "
                "visual modalities of one step), bf16; launches: the "
                "preprocessing of one rgbflow and one flagship train batch "
                "(make_batch_preprocessor), once a visual modality; the "
                "full-width steps run no preprocessing"}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
