#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adamml_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

(``chip_smoke.py --mp-worker ...`` is one rank of the multi_process or
tensor_parallel phase, started by the script itself.)

Phases, each printing one JSON line (or several):

  device      card name, count, and nvidia-smi's name and power limit;
  build       nvcc builds every CUDA kernel from csrc/ (one process per
              source, all at once) and prints ptxas' registers, shared
              memory, spills;
  one_kernel_a_call  torch.profiler's count of kernels in one depthwise
              forward call and one stride-1 input-gradient call (one
              each), and in one call of the epilogue's backward (the
              plan's one), before any other profiled run;
  kernel      the fused epilogue's forward kernel against its plain PyTorch
              version, at the flagship eval shapes and at grouped, float32
              and odd-F cases, with CUDA-event times beside the bound;
              then on a channel block against its full-C launch;
  kernel_bwd  the backward kernel against its plain version, at the three
              flagship train shapes (R = 1, S = 5), float32, odd F, R = 2
              and an engineered tie, with the same timings, registers,
              spills, blocks an SM and partials bytes per stage; each
              case launched twice (bit-identical) and, but for stages 1
              and 2, its per-row sums held to the plan's order (bwd_plan,
              planned_row_sums) bit for bit; then on a channel block
              against its full-C launch
              (bit for bit, da and db too), and a CUDA graph of the
              backward alone, replayed, against an eager call;
  bn_kernel   train-mode BN's six kernels (ops/kernels/bn_train.py) at
              every distinct BN call of one flagship main-phase step at
              18 clips, each checked against its plain version on the
              same tensors (largest error printed) and timed with CUDA
              events (L2 zeroed) beside its byte bound and its plain
              version's time, the per-step sums, ptxas' registers, and
              the BN launches of one step checked against the step's BN
              calls;
  serve       the flagship AdaMML eval step at full width (ResNet-50 +
              MobileNetV2 audio, rgb + sound, 5 segments x 8 frames,
              224x224, LSTM policy, learnable late fusion, bf16, 31
              classes), seeded random weights, 4 requests of 8 clips after
              one warm-up; launch counts zeroed just before and read just
              after; outputs checked against the plain composition
              (fused_tpool=False);
  train       the flagship train step at full width, main phase (SGD on the
              main net) then policy phase (Adam on the policy net), 8 clips
              a step, 1 warm-up and 3 timed steps each; launch counts zeroed
              just before each phase and read just after, the BN kernels'
              checked against the phase's train-mode BN calls; checks on
              losses, decisions, which parameters and statistics moved;
  train_vs_plain  one main-phase step with fused_tpool=False on the same
              weights and batch: loss and updates against the fused step;
  serve_dw    the same eval step with use_pallas_dw=True: every 3x3
              depthwise layer of the three MobileNetV2s runs the depthwise
              kernel (51 launches a batch beside the epilogue's 3); then
              the same weights and batch with the depthwise op patched to
              its plain version (0 kernel launches) for comparison; and
              the kernels one eval step puts on the card (torch.profiler)
              with the flag, at most 5 more than without it;
  train_dw    both train phases with use_pallas_dw=True, with the
              depthwise kernel's forward and input-gradient launches of
              every step asserted (main 51 + 13, policy 85 + 26: the
              policy trunks' remat runs their forward again);
  multi_step  the multi-step dispatch (make_adamml_multi_step, K = 2
              train steps captured as one CUDA graph and replayed) of the
              flagship at full width in both phases: from one snapshot the
              replay against K calls of the single step
              (make_adamml_train_step), bit for bit (parameters, BN
              statistics, optimizer state, step, metrics); the epilogue
              kernels of one replay and of K single steps counted in a
              device trace; ms per step, host ms per dispatch, device idle
              share and peak memory, single steps against replayed; then the tiny config with use_pallas_dw=True in
              the policy phase (the depthwise kernel and the trunks' remat
              under capture);
  eval_capacity  eval-capacity conditional compute at full width,
              capacity 1.0, 0.5 and 0.25 in one block and 0.5 in two:
              packed logits against the unpacked net's masked logits with
              forced decisions, the epilogue's launches on the packed row
              counts, eval ms, validate's capacity_dropped against a count
              made here; then the forward epilogue kernel against its
              plain version at N = 20 and 10 (kernel_packed lines);
  kernel_dw   the depthwise kernel against its plain version at every
              distinct layer of serve_dw (bf16, taps as the model passes
              them), timed as the kernel alone (kernel_ms: the C entry with
              its arguments bound outside the timed span) and as the whole
              call (call_ms), beside the bound, the plain version and
              cuDNN's depthwise convolution (library_ms), per layer and
              summed by stride; then float32, odd sizes, asymmetric
              stride-2 padding, an affine with ReLU6, C % 8 != 0, sizes
              that cross the tiles' edges, the flipped-tap input gradient
              and a determinism check; and the step's 51 layers launched
              back to back in one CUDA-event window (back_to_back);
  tiny_reference, tiny_train  the tiny float32 config on the card against
              the CPU (eval forward; one step of each phase), then the same
              with use_pallas_dw=True (tiny_dw_reference, tiny_dw_train);
  tools       the stage-boundary prototype kernel against its plain version,
              then the kernel tools (adamml_tpu_torch/tools/bench_depthwise,
              bench_tpool and bench_tpool_bwd: the backward kernel on its
              plan and on others, beside PyTorch's add) at their shapes;
  update_mem  the optimizer-update and memory tools at flagship width:
              adamml_tpu_torch/tools/bench_update (SGD over the main net,
              Adam over the policy net; per-tensor, foreach and one flat
              vector: ms per update, launches, bound and share, the rows
              agreeing), then tools/mem_analysis at batch 8 in both
              phases with the fused epilogue on and off (the step's
              arguments, peak and ten largest blocks, its epilogue
              launches; the main phase's peak within 5% of train's) and at
              batch 24 in the policy phase;
  preprocess_card_vs_cpu  one flagship synthetic batch through the device
              preprocessing on the card and on the CPU (float32, 1e-3);
  cli         both training CLIs in process, as a user runs them:
              train_adamml at the flagship's full width through warmup,
              alternating and finetune on 16 synthetic videos, then its -e
              evaluation, then train_unimodal (rgb ResNet-50); launch
              counts zeroed before each run and read after, and every
              epoch's epilogue launches checked; stage seconds, the
              engine's ms/batch, data ms/batch and peak memory; then
              train_adamml with --steps_per_dispatch 2 --eval_capacity 0.5
              --profile_dir on 48 videos (each pass's trace holds one
              replay, its kernels counted) and --show_model's FLOP count;
  real_data   the paper's recipe on real files: a kinetics-sounds tree
              generated here (16 videos of 64 JPEGs at 256x340, 24 kHz
              WAVs, one video without its WAV), the decoder that loads
              and its ms per frame, one real batch's preprocessing on the
              card against the CPU, train_unimodal rgb and sound, the
              flagship curriculum with --unimodality_pretrained (graft
              checked bit for bit), then -e --pretrained (tensors and
              temperature checked) and --pred_files on the file -e wrote
              (its top-1 equal to the evaluation's); every epoch's
              epilogue launches and every JPEG's decoder counted;
  multi_process  data-parallel runs (adamml_tpu_torch/parallel/mesh.py):
              (a) NCCL at world size 1 in this process, the flagship at
              full width in both BN modes, each step through the
              distributed code bit-equal to the step without a group, then
              the K = 2 replay with its collectives captured against K
              single steps; (b) two processes sharing the card over gloo
              (this script with --mp-worker), the flagship at full width,
              4 rows a rank of a global 8, 3 main and 3 policy steps in
              each BN mode: the ranks bit-identical after every step, each
              rank's main-step trace with 3 forward and 3 backward
              epilogue kernels, ms per step against world size 1, the
              gradient all-reduce's bytes and ms, peak memory per rank;
              then the tiny float32 config against the single process at
              bn_groups 2 (1 under --sync-bn); (c) both CLIs at world size
              2 (the same Val lines on both ranks, every validation of
              the dataset's rows, checkpoints from rank 0 alone,
              model_best loaded on both ranks), then train_unimodal with
              --multiprocessing-distributed;
  tensor_parallel  --mesh_model and packing across ranks, every rank a
              process over gloo sharing the card: (a) the flagship at
              (1, 2), 3 main and 3 policy steps on all 8 clips (ranks
              bit-identical after every step, the four sharded policy
              layers, each rank's epilogue launches and main-step trace,
              the collectives' calls, bytes and ms, ms per step against
              world size 1, peak memory), (b) the tiny float32 config at
              (1, 2) against the single process, (c) the main net at
              (2, 1) with eval capacity 0.5 in 5 blocks of the 40 rows
              (one spans the ranks) against the single process, its
              capacity_dropped and epilogue row counts, (d) train_adamml
              at --mesh_model 2 (equal Val lines, rank 0's unsharded
              checkpoint), then -e --pretrained on it at (1, 2) and at
              world size 1 (one Val line);
  kernels     one object per ported kernel, as in PERF.md's table.

Then nvidia-smi's name and power limit, and last
{"ok": true, "device": {...}}. Any failed check raises and the script exits
non-zero without that line. Without CUDA it exits 1 and prints no result.
TF32 is off for convolutions and matmuls, since float32 results are
compared with the plain versions and with the CPU.
"""

from __future__ import annotations

import contextlib
import glob
import inspect
import io
import json
import math
import os
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from adamml_tpu_torch.cli import train_adamml, train_unimodal
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.configs.config import arg_parser, config_from_args
from adamml_tpu_torch.data import loaders
from adamml_tpu_torch.data.device_pipeline import make_batch_preprocessor
from adamml_tpu_torch.data.native_decode import load_error, native_available
from adamml_tpu_torch.data.video_dataset import VideoDataset
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.models.mobilenet_v2 import _DepthwiseConv
from adamml_tpu_torch.models.model_builder import build_model, example_inputs
from adamml_tpu_torch.models.norm import EPSILON, MOMENTUM, GroupedBatchNorm
from adamml_tpu_torch.ops.augment import policy_stream
from adamml_tpu_torch.ops.kernels import bn_train as tbn
from adamml_tpu_torch.ops.kernels import build
from adamml_tpu_torch.ops.kernels import depthwise as dwk
from adamml_tpu_torch.ops.kernels import tpool_fused as tp
from adamml_tpu_torch.ops.kernels import tpool_proto as tpp
from adamml_tpu_torch.tools import (bench_depthwise, bench_pipeline,
                                    bench_tpool, bench_tpool_bwd,
                                    bench_update, mem_analysis)
from adamml_tpu_torch.tools.timing import (F32_OPS_PER_S, HBM_BYTES_PER_S,
                                           bf16_ulp, bound_ms)
from adamml_tpu_torch.tools.timing import device_trace as _device_trace
from adamml_tpu_torch.tools.timing import (event_ms, l2_flush_buffer,
                                           nvidia_smi, within_one_bf16_ulp)
from adamml_tpu_torch.train import curriculum as cur
from adamml_tpu_torch.train.engine import validate
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.steps import (make_adamml_eval_step,
                                          make_adamml_multi_step,
                                          make_adamml_train_step)
from adamml_tpu_torch.train.train_state import (EvalState, StageFlags,
                                                TrainState)
from adamml_tpu_torch.utils.logging import RankZeroLogger

# the train step's settings (bench.py:156-161)
LR, P_LR, COST, GAMMAS = 1e-3, 1e-2, [1.0, 0.05], 10.0
COUNTS = (tp.launch_counts, dwk.launch_counts, tpp.launch_counts,
          tbn.launch_counts)
# depthwise launches (forward, input gradient) of one flagship step with
# use_pallas_dw=True: 17 layers in each of three MobileNetV2s; the main
# phase adds the audio backbone's 13 stride-1 input gradients; the policy
# phase adds the two trunks' forward again (remat) and their 26
DW_STEP = {"eval": (51, 0), "main": (51, 13), "policy": (85, 26)}


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


def dw_launches(before: dict) -> tuple:
    """(forward, input-gradient) depthwise launches since ``before``."""
    return (dwk.launch_counts[dwk.KERNEL] - before[dwk.KERNEL],
            dwk.launch_counts[dwk.KERNEL_DX] - before[dwk.KERNEL_DX])


def host_call_ms(fn, iters: int = 50) -> float:
    """Host time of one call of a wrapper, its launch included: the mean
    over ``iters`` calls queued behind a spin of the card, so the host
    never waits for it."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return dt * 1e3


def tpool_work(n, f, h, w, c, itemsize):
    """(bytes, float32 ops) the fused epilogue must move and do."""
    fo = (f - 1) // 2 + 1
    bytes_ = (2 * n * f + n * fo) * h * w * c * itemsize
    window_cmp = sum(min(f, 2 * k + 2) - max(0, 2 * k - 1) - 1
                     for k in range(fo))
    ops = (4 * n * f + window_cmp * n) * h * w * c  # mul, 2 add, relu; max
    return bytes_, ops


# (label, N, F, H, W, C, R, S, dtype, timed): the three flagship stage
# boundaries (8 clips x 5 segments = 40 rows, eval affine R = S = 1), then
# a grouped affine, float32 and odd frame counts
KERNEL_CASES = [
    ("stage1", 40, 8, 56, 56, 256, 1, 1, torch.bfloat16, True),
    ("stage2", 40, 4, 28, 28, 512, 1, 1, torch.bfloat16, True),
    ("stage3", 40, 2, 14, 14, 1024, 1, 1, torch.bfloat16, True),
    ("grouped_R2_S5", 40, 4, 7, 7, 64, 2, 5, torch.bfloat16, False),
    ("f32_S2", 8, 8, 14, 14, 128, 1, 2, torch.float32, False),
    ("oddF3", 10, 3, 9, 9, 32, 1, 5, torch.bfloat16, False),
    ("oddF5_f32", 6, 5, 12, 12, 48, 2, 3, torch.float32, False),
]


def kernel_phase(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = l2_flush_buffer(dev)
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "bytes_s": 0.0, "ops_s": 0.0}
    for label, n, f, h, w, c, r, s, dtype, timed in KERNEL_CASES:
        y = torch.randn((n, f, h, w, c), generator=gen, device=dev).to(dtype)
        ident = torch.randn((n, f, h, w, c), generator=gen,
                            device=dev).to(dtype)
        a = 1.0 + 0.3 * torch.randn((r, s, c), generator=gen, device=dev)
        b = 0.1 * torch.randn((r, s, c), generator=gen, device=dev)
        got = tp.fused_bn_add_relu_tpool(y, ident, a, b)
        want = tp.reference_impl(y, ident, a, b)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        if dtype == torch.bfloat16:
            ok, tol = within_one_bf16_ulp(got, want), "1 bf16 ulp"
        else:
            ok = bool(((got - want).abs() <= 1e-6 * want.abs()).all())
            tol = "1e-6 relative"
        check(ok, f"{label}: kernel disagrees with the plain version "
                  f"beyond {tol} (max abs err {err})")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        line = dict(case=label, shape=[n, f, h, w, c], R=r, S=s,
                    dtype=str(dtype).replace("torch.", ""),
                    max_abs_err=err, tolerance=tol)
        if timed:
            nbytes, ops = tpool_work(n, f, h, w, c, y.element_size())
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
            bound = max(bytes_s, ops_s) * 1e3
            k_ms = event_ms(lambda: tp.fused_bn_add_relu_tpool(y, ident, a, b),
                            flush=flush)
            host_ms = host_call_ms(lambda: tp.fused_bn_add_relu_tpool(
                y, ident, a, b))
            p_ms = event_ms(lambda: tp.reference_impl(y, ident, a, b),
                            flush=flush)
            line.update(kernel_ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                        bound_by="bytes" if bytes_s >= ops_s
                        else "operations",
                        bytes=nbytes, ops=ops,
                        achieved_GBps=nbytes / k_ms / 1e6,
                        share_of_bound=bound / k_ms, library_ms=None,
                        wrapper_host_ms=host_ms,
                        timing="CUDA events, mean of 20 after 3 warm-up, "
                               "L2 flushed between launches")
            res["ms"] += k_ms
            res["plain_ms"] += p_ms
            res["bound_ms"] += bound
            res["bytes_s"] += bytes_s
            res["ops_s"] += ops_s
        emit("kernel", **line)
        del y, ident, got, want
    _kernel_channel_block(dev, gen)
    return res


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


def bn_counts(counts: dict) -> dict:
    """The BN kernels' entries of a launch-count dict."""
    return {k: counts[k] for k in tbn.KERNELS}


def _bn_calls(dev, batch: int) -> tuple:
    """Every train-mode BN call of one flagship main-phase step at ``batch``
    clips (after a warm-up step), as ``bn_call_hooks`` counts them, and the
    BN kernels' launches of that step, counts zeroed just before."""
    cfg = flagship_cfg()
    model, _ = build_model(cfg)
    state = _train_state(model, cfg)
    step = _make_step(model, "main")
    gen = torch.Generator(device=dev).manual_seed(3)
    target = torch.randint(0, cfg.model.num_classes, (batch,), generator=gen,
                           device=dev)
    step(state, example_inputs(cfg, batch=batch, seed=300), target, LR,
         P_LR, COST, seed=0)
    inputs = example_inputs(cfg, batch=batch, seed=301)
    calls, hooks = bn_call_hooks(model)
    torch.cuda.synchronize()
    zero_counts()
    step(state, inputs, target, LR, P_LR, COST, seed=1)
    torch.cuda.synchronize()
    launches = bn_counts(all_counts())
    for h in hooks:
        h.remove()
    del model, state, step
    torch.cuda.empty_cache()
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


BN_TOLERANCE = ("sums within 1e-5 of the sums of their terms' magnitudes; "
                "finalize outputs within 1e-5 of each output's largest "
                "entry; y and dx within 1 bf16 ulp or 1e-6 of their terms' "
                "magnitudes (tests/test_torch_gpu.py::"
                "test_cuda_bn_kernels_match_plain)")


def bn_check(geom, x, dy, w, bias, affine: bool) -> tuple:
    """Each BN kernel against its plain version on the same card tensors,
    in the card test's tolerances (BN_TOLERANCE); the finalize kernels on
    the stats pass's sums (and, with ``affine``, (a, b) standing for the
    epilogue's gradients), dx without its dy term with ``affine``.
    Returns ({kernel: largest absolute error}, the kernels' (sums, mom,
    a, b, gsums, coef) for the timed calls)."""
    errs = {}

    def within(name, got, want, bound, ulp=False):
        err = (got.float() - want.float()).abs()
        tol = torch.maximum(bf16_ulp(want), bound) if ulp else bound
        over = float((err - tol).max())
        check(over <= 0, f"{name} at {geom} (return_affine={affine}) "
              f"differs from its plain version by {over} past its tolerance")
        errs[name] = max(errs.get(name, 0.0), float(err.max()))

    ulp = x.dtype == torch.bfloat16
    xf, dyf = x.float(), dy.float()
    part = tbn.stats(x, geom)
    within("bn_stats", part.sum(1), tbn.plain_stats(x, geom)[:, 0],
           1e-5 * tbn.plain_stats(xf.abs(), geom)[:, 0])
    sums = tbn.slab_views(part)
    args = (geom.count / (geom.count - 1), MOMENTUM, EPSILON,
            tbn.MOMENTS | tbn.AFFINE)
    run_k = (torch.zeros(geom.c, device=x.device),
             torch.ones(geom.c, device=x.device))
    run_p = tuple(t.clone() for t in run_k)
    got = tbn.finalize(sums, None, w, bias, run_k, geom, *args)
    want = tbn.plain_finalize(sums, None, w, bias, run_p, geom, *args)
    for g, v in zip(got + run_k, want + run_p):
        within("bn_finalize", g, v, 1e-5 * float(v.abs().max()))
    mom, a, b = got
    if affine:
        gsums = tuple(t.reshape(geom.g, 1, geom.c) for t in (a, b))
    else:
        within("bn_apply", tbn.apply(x, a, b, geom),
               tbn.plain_apply(x, a, b, geom),
               1e-6 * tbn.plain_apply(xf.abs(), a.abs(), b.abs(), geom),
               ulp)
        gpart = tbn.grad_sums(dy, x, geom)
        within("bn_grad_sums", gpart.sum(1),
               tbn.plain_grad_sums(dy, x, geom)[:, 0],
               1e-5 * tbn.plain_grad_sums(dyf.abs(), xf.abs(), geom)[:, 0])
        gsums = tbn.slab_views(gpart)
    got = tbn.grad_finalize(gsums, mom, w, geom, EPSILON)
    want = tbn.plain_grad_finalize(gsums, mom, w, geom, EPSILON)
    for g, v in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        within("bn_grad_finalize", g, v, 1e-5 * float(v.abs().max()))
    coef = got[2]
    d, df = (None, None) if affine else (dy, dyf.abs())
    within("bn_dx", tbn.dx(d, x, coef, geom), tbn.plain_dx(d, x, coef, geom),
           1e-6 * tbn.plain_dx(df, xf.abs(), coef.abs(), geom).float(), ulp)
    return errs, (sums, mom, a, b, gsums, coef)


def bn_kernel_phase(dev) -> dict:
    """The six BN kernels at every distinct train-mode BN call of one
    flagship main-phase step (18 clips), each first checked against its
    plain version (``bn_check``) and then timed with CUDA events (L2
    zeroed between launches) beside its byte bound and its plain version's
    time; per-step sums weighted by the calls; and the BN kernels'
    launches of one step, checked against its calls."""
    calls, launches = _bn_calls(dev, BN_BATCH)
    want = bn_launches(calls)
    check(launches == want, f"one main-phase step launched the BN kernels "
          f"{launches}, expected {want}")
    emit("bn_launches", step="main", batch_clips=BN_BATCH, launches=launches,
         bn_calls=sum(calls.values()),
         with_backward=sum(k for key, k in calls.items() if key[2]),
         return_affine=sum(k for key, k in calls.items() if key[1]))
    flush = l2_flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "launches": 0,
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
        run = (torch.zeros(geom.c, device=dev), torch.ones(geom.c,
                                                           device=dev))
        args = (geom.count / (geom.count - 1), MOMENTUM, EPSILON,
                tbn.MOMENTS | tbn.AFFINE)
        errs, (sums, mom, a, b, gsums, coef) = bn_check(geom, x, dy, w, bias,
                                                       affine)
        d = None if affine else dy
        psums = tbn.slab_views(tbn.plain_stats(x, geom))
        pgsums = (tbn.slab_views(tbn.plain_grad_sums(dy, x, geom))
                  if not affine else gsums)
        fns = {
            "bn_stats": (lambda: tbn.stats(x, geom),
                         lambda: tbn.plain_stats(x, geom)),
            "bn_finalize": (
                lambda: tbn.finalize(sums, None, w, bias, run, geom, *args),
                lambda: tbn.plain_finalize(psums, None, w, bias, run, geom,
                                           *args)),
            "bn_apply": (lambda: tbn.apply(x, a, b, geom),
                         lambda: tbn.plain_apply(x, a, b, geom)),
            "bn_grad_sums": (lambda: tbn.grad_sums(dy, x, geom),
                             lambda: tbn.plain_grad_sums(dy, x, geom)),
            "bn_grad_finalize": (
                lambda: tbn.grad_finalize(gsums, mom, w, geom, EPSILON),
                lambda: tbn.plain_grad_finalize(pgsums, mom, w, geom,
                                                EPSILON)),
            "bn_dx": (lambda: tbn.dx(d, x, coef, geom),
                      lambda: tbn.plain_dx(d, x, coef, geom)),
        }
        pl = tbn.plan(geom, tbn.vec_width(geom.c, 2),
                      torch.cuda.get_device_properties(
                          dev).multi_processor_count)
        line = dict(shape=list(shape), R=geom.r, S=geom.s, si=geom.si,
                    return_affine=affine, backward=bwd, calls=k,
                    plan={q: pl[q] for q in ("vec", "tcg", "lanes", "ns", "k",
                                             "slab", "blocks",
                                             "partials_bytes")})
        for name, nbytes in bn_work(geom, 2, affine, bwd, input_grad).items():
            kern, plain = fns[name]
            k_ms = event_ms(kern, flush=flush)
            p_ms = event_ms(plain, iters=5, warmup=1, flush=flush)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            line[name] = dict(kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                              share_of_bound=b_ms / k_ms if b_ms else None,
                              max_abs_err=errs[name])
            tot[name]["ms"] += k * k_ms
            tot[name]["plain_ms"] += k * p_ms
            tot[name]["bound_ms"] += k * b_ms
            tot[name]["launches"] += k
            tot[name]["max_abs_err"] = max(tot[name]["max_abs_err"],
                                           errs[name])
        emit("bn_kernel", **line, tolerance=BN_TOLERANCE)
        del x, dy, sums, mom, a, b, gsums, coef, psums, pgsums, fns
    for t in tot.values():
        t["share_of_bound"] = t["bound_ms"] / t["ms"] if t["ms"] else None
    step_ms = sum(t["ms"] for t in tot.values())
    bound = sum(t["bound_ms"] for t in tot.values())
    plain = sum(t["plain_ms"] for t in tot.values())
    errs = {k: t["max_abs_err"] for k, t in tot.items()}
    emit("bn_kernel_sum", batch_clips=BN_BATCH, per_kernel=tot,
         ms_per_step=step_ms, bound_ms_per_step=bound,
         plain_ms_per_step=plain, share_of_bound=bound / step_ms,
         ptxas=build.ptxas_entries(tbn.SOURCE),
         timing="CUDA events, mean of 20 after 3 warm-up (plain: 5 after "
                "1), L2 zeroed between launches, bf16; sums weighted by "
                "the calls of one main-phase step")
    return dict(tot, ms=step_ms, bound_ms=bound, plain_ms=plain,
                launches=launches, max_abs_err=errs)


def _block(t, lo, hi):
    return t[..., lo:hi].contiguous()


def _kernel_channel_block(dev, gen) -> None:
    """The forward kernel on the upper 'model' channel block [C/2, C) of
    the stage-2 shape (the JAX kernel's shard-local channel block,
    tests/test_tpool_sharded.py's 2-D mesh), with the affine's matching
    slice, against that block of its full-C launch: bit for bit."""
    n, f, h, w, c = 40, 4, 28, 28, 512
    lo, hi = c // 2, c
    y, ident = (torch.randn((n, f, h, w, c), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
    a = 1.0 + 0.3 * torch.randn((1, 5, c), generator=gen, device=dev)
    b = 0.1 * torch.randn((1, 5, c), generator=gen, device=dev)
    whole = tp.fused_bn_add_relu_tpool(y, ident, a, b)
    got = tp.fused_bn_add_relu_tpool(*(_block(v, lo, hi)
                                       for v in (y, ident, a, b)))
    check(torch.equal(got, _block(whole, lo, hi)),
          "channel_block: the forward kernel on channels "
          f"[{lo}, {hi}) differs from that block of its full-C launch")
    emit("kernel", case="channel_block", shape=[n, f, h, w, c], R=1, S=5,
         channels=[lo, hi], dtype="bfloat16", bit_equal_to_full_c=True)


def tpool_bwd_work(n, f, h, w, c, itemsize):
    """(bytes, float32 ops) the fused epilogue's backward must move and do:
    read y, ident and ct, write dident and dy (a, b, da, db are a few
    R*S*C floats). About 14 ops per input element: pre (3), relu, window
    max and first-max selection (4), route and mask (2), the two partial
    sums (3), dy (1), counted loosely; bytes bound it by far either way."""
    fo = (f - 1) // 2 + 1
    bytes_ = (4 * n * f + n * fo) * h * w * c * itemsize
    return bytes_, 14 * n * f * h * w * c


# (label, N, F, H, W, C, R, S, dtype, timed): the three flagship stage
# boundaries in training (8 clips x 5 segments = 40 rows, one group per
# segment: R = 1, S = 5), then float32, odd frame counts and R = 2
BWD_CASES = [
    ("stage1", 40, 8, 56, 56, 256, 1, 5, torch.bfloat16, True),
    ("stage2", 40, 4, 28, 28, 512, 1, 5, torch.bfloat16, True),
    ("stage3", 40, 2, 14, 14, 1024, 1, 5, torch.bfloat16, True),
    ("f32_S2", 8, 8, 14, 14, 128, 1, 2, torch.float32, False),
    ("oddF3", 10, 3, 9, 9, 32, 1, 5, torch.bfloat16, False),
    ("oddF5_f32", 6, 5, 12, 12, 48, 2, 3, torch.float32, False),
    ("R2_S5", 40, 4, 7, 7, 64, 2, 5, torch.bfloat16, False),
]


def _bwd_case_inputs(label, n, f, h, w, c, r, s, dtype, gen, dev):
    if label == "ties":
        # every frame equal and positive: each window's cotangent must go
        # to its first frame (tests/test_pallas.py:171-191)
        frame = torch.randn((n, 1, h, w, c), generator=gen,
                            device=dev).abs() + 0.5
        y = frame.repeat(1, f, 1, 1, 1).to(dtype)
        ident = torch.zeros_like(y)
        a = torch.ones((r, s, c), device=dev)
        b = torch.zeros((r, s, c), device=dev)
    else:
        y = torch.randn((n, f, h, w, c), generator=gen, device=dev).to(dtype)
        ident = torch.randn((n, f, h, w, c), generator=gen,
                            device=dev).to(dtype)
        a = 1.0 + 0.3 * torch.randn((r, s, c), generator=gen, device=dev)
        b = 0.1 * torch.randn((r, s, c), generator=gen, device=dev)
    ct = torch.randn((n, (f - 1) // 2 + 1, h, w, c), generator=gen,
                     device=dev).to(dtype)
    return y, ident, a, b, ct


# the backward cases whose planned sum order is emulated on the host
# (planned_row_sums): stage 3 and the small ones; stages 1 and 2 would
# take the host tens of seconds
PLANNED_ON_CPU_MAX = 1 << 25


def bwd_ptxas() -> dict:
    """The backward kernel's instantiations from its build log, by dtype:
    registers, spills, stack and static shared memory (every one must
    spill nothing)."""
    got = {}
    for e in build.ptxas_entries(tp.KERNEL_BWD):
        if BWD_NAME not in e["entry"]:
            continue
        dtype = "bfloat16" if "bfloat16" in e["entry"] else "float32"
        got[dtype] = {k: e[k] for k in ("registers", "spill_stores",
                                        "spill_loads", "stack", "smem")}
    check(sorted(got) == ["bfloat16", "float32"],
          f"the backward kernel's build log names {sorted(got)}")
    for dtype, e in got.items():
        check(e["spill_stores"] == e["spill_loads"] == 0,
              f"the backward kernel ({dtype}) spills: {e}")
    return got


def blocks_per_sm(registers: int, smem: int, threads: int) -> int:
    """Resident blocks an H100 SM holds of a kernel: its 65,536 registers
    (allocated 256 a warp at a time), its 233,472 bytes of shared memory
    (1,024 of them reserved per block) and 2,048 threads."""
    warps = -(-threads // 32)
    regs = -(-registers * 32 // 256) * 256 * warps
    return min(65536 // regs, 233472 // (smem + 1024), 2048 // threads)


def _bwd_graph_replay(dev, gen) -> None:
    """The backward alone captured in a CUDA graph (its memset, tickets and
    scratch inside the capture) and replayed on new inputs copied into the
    captured ones: bit for bit the eager call on those inputs."""
    args = _bwd_case_inputs("graph", 40, 4, 28, 28, 512, 1, 5,
                            torch.bfloat16, gen, dev)
    static = [t.clone() for t in args]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tp.fused_bn_add_relu_tpool_bwd(*static)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tp.fused_bn_add_relu_tpool_bwd(*static)
    for seed in (1, 2):
        fresh = _bwd_case_inputs(
            "graph", 40, 4, 28, 28, 512, 1, 5, torch.bfloat16,
            torch.Generator(device=dev).manual_seed(seed), dev)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        want = tp.fused_bn_add_relu_tpool_bwd(*fresh)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w_) for g, w_ in zip(out, want)),
              f"graph replay {seed}: the backward differs from an eager "
              "call on the same inputs")
    emit("kernel_bwd", case="graph_replay", shape=[40, 4, 28, 28, 512],
         replays=2, bit_equal_to_eager=True)
    del graph, static, out, want


def kernel_bwd_phase(dev) -> dict:
    """The backward kernel against reference_bwd. dy and dident within one
    bf16 ulp (float32: 1e-6 relative); the kernel rounds where the plain
    version does, so both are expected bit-equal. da and db within 1e-4 of
    their largest entry: float32 sums of up to F*H*W*N/(R*S) terms (200,704
    at stage 1) taken in another order. Every case twice, bit for bit; the
    per-row sums (before the plain per-group sum) bit for bit those of
    ``planned_row_sums`` on the CPU, in the order ``bwd_plan`` states, for
    every case up to PLANNED_ON_CPU_MAX elements."""
    gen = torch.Generator(device=dev).manual_seed(10)
    flush = l2_flush_buffer(dev)
    ptxas = bwd_ptxas()
    res = {"max_abs_err": 0.0, "dab_max_rel_err": 0.0, "ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "bytes_s": 0.0, "ops_s": 0.0,
           "stages": [], "ptxas": ptxas}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = BWD_CASES + [("ties", 2, 4, 8, 8, 8, 1, 1, torch.bfloat16,
                          False)]
    for label, n, f, h, w, c, r, s, dtype, timed in cases:
        y, ident, a, b, ct = _bwd_case_inputs(label, n, f, h, w, c, r, s,
                                              dtype, gen, dev)
        got = tp.fused_bn_add_relu_tpool_bwd(y, ident, a, b, ct)
        want = tp.reference_bwd(y, ident, a, b, ct)
        again = tp.fused_bn_add_relu_tpool_bwd(y, ident, a, b, ct)
        torch.cuda.synchronize()
        check(all(torch.equal(g, g2) for g, g2 in zip(got, again)),
              f"{label}: two launches on the same inputs differ")
        plan = tp.bwd_plan(n, f, h, w, c, y.element_size(), sms)
        if y.numel() <= PLANNED_ON_CPU_MAX:
            rows = tp._launch_bwd_rows(y, ident, a, b, ct)[2].cpu()
            planned = tp.planned_row_sums(
                tp.routed_dpre(y.cpu(), ident.cpu(), a.cpu(), b.cpu(),
                               ct.cpu()), y.cpu(), plan)
            check(torch.equal(rows, planned),
                  f"{label}: the kernel's per-row sums differ from the "
                  f"plan's order (max abs "
                  f"{float((rows - planned).abs().max())})")
        errs = [float((g.float() - w_.float()).abs().max())
                for g, w_ in zip(got, want)]
        for g, w_, what in zip(got[:2], want[:2], ("dy", "dident")):
            check(bool(torch.isfinite(g).all()), f"{label}: non-finite {what}")
            if dtype == torch.bfloat16:
                ok, tol = within_one_bf16_ulp(g, w_), "1 bf16 ulp"
            else:
                ok = bool(((g - w_).abs() <= 1e-6 * w_.abs()).all())
                tol = "1e-6 relative"
            check(ok, f"{label}: {what} disagrees with the plain version "
                      f"beyond {tol} (max abs err {errs[0:2]})")
        dab_rel = max(e / max(float(w_.abs().max()), 1e-30)
                      for e, w_ in zip(errs[2:], want[2:]))
        check(dab_rel <= 1e-4, f"{label}: da/db off by {dab_rel} of their "
                               "largest entry (tolerance 1e-4)")
        if label == "ties":
            check(torch.equal(got[1][:, :2], ct)
                  and not bool(got[1][:, 2:].any()),
                  "ties: cotangent not routed to the first maximum")
        res["max_abs_err"] = max(res["max_abs_err"], *errs[:2])
        res["dab_max_rel_err"] = max(res["dab_max_rel_err"], dab_rel)
        line = dict(case=label, shape=[n, f, h, w, c], R=r, S=s,
                    dtype=str(dtype).replace("torch.", ""),
                    max_abs_err_dy_dident=max(errs[:2]),
                    max_abs_err_da_db=max(errs[2:]),
                    rel_err_da_db=dab_rel,
                    tolerance="dy, dident: " + (
                        "1 bf16 ulp" if dtype == torch.bfloat16
                        else "1e-6 relative") + "; da, db: 1e-4 of max",
                    two_launches_bit_identical=True,
                    rows_bit_equal_to_plan=(True if y.numel()
                                            <= PLANNED_ON_CPU_MAX
                                            else "not emulated"),
                    plan={k: plan[k] for k in (
                        "blocks", "chunks", "chunk_pixels", "slices",
                        "slice_groups", "waves", "partials_bytes")})
        if timed:
            nbytes, ops = tpool_bwd_work(n, f, h, w, c, y.element_size())
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
            bound = max(bytes_s, ops_s) * 1e3
            k_ms = event_ms(lambda: tp.fused_bn_add_relu_tpool_bwd(
                y, ident, a, b, ct), flush=flush)
            host_ms = host_call_ms(lambda: tp.fused_bn_add_relu_tpool_bwd(
                y, ident, a, b, ct))
            p_ms = event_ms(lambda: tp.reference_bwd(y, ident, a, b, ct),
                            iters=5, warmup=1, flush=flush)
            line.update(kernel_ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                        bound_by="bytes" if bytes_s >= ops_s
                        else "operations",
                        bytes=nbytes, ops=ops,
                        achieved_GBps=nbytes / k_ms / 1e6,
                        share_of_bound=bound / k_ms, library_ms=None,
                        wrapper_host_ms=host_ms,
                        timing="CUDA events, kernel mean of 20 after 3 "
                               "warm-up, plain mean of 5 after 1, L2 "
                               "flushed between launches")
            regs = ptxas["bfloat16" if dtype == torch.bfloat16
                         else "float32"]
            stage = dict(case=label, kernel_ms=k_ms, bound_ms=bound,
                         share_of_bound=bound / k_ms, plain_ms=p_ms,
                         library_ms=None, registers=regs["registers"],
                         spill_bytes=regs["spill_stores"]
                         + regs["spill_loads"],
                         blocks_per_sm=blocks_per_sm(
                             regs["registers"],
                             plan["smem_bytes"] + regs["smem"],
                             plan["threads"]),
                         blocks=plan["blocks"],
                         partials_bytes=plan["partials_bytes"],
                         partials_share_of_bound_bytes=plan[
                             "partials_bytes"] / nbytes)
            line.update({k: v for k, v in stage.items() if k not in line})
            res["stages"].append(stage)
            res["ms"] += k_ms
            res["plain_ms"] += p_ms
            res["bound_ms"] += bound
            res["bytes_s"] += bytes_s
            res["ops_s"] += ops_s
        emit("kernel_bwd", **line)
        del y, ident, a, b, ct, got, want, again
    _kernel_bwd_channel_block(dev, gen)
    _bwd_graph_replay(dev, gen)
    torch.cuda.empty_cache()
    return res


def _kernel_bwd_channel_block(dev, gen) -> None:
    """The backward kernel on the upper channel block [C/2, C) of the
    stage-2 train shape against that block of its full-C launch, bit for
    bit: dy and dident, and da and db, whose sum order follows the plan's
    pixel lanes and chunks, which do not depend on C (bwd_plan)."""
    n, f, h, w, c = 40, 4, 28, 28, 512
    lo, hi = c // 2, c
    args = _bwd_case_inputs("block", n, f, h, w, c, 1, 5, torch.bfloat16,
                            gen, dev)
    whole = tp.fused_bn_add_relu_tpool_bwd(*args)
    got = tp.fused_bn_add_relu_tpool_bwd(*(_block(v, lo, hi) for v in args))
    for g, w_, what in zip(got[:2], whole[:2], ("dy", "dident")):
        check(torch.equal(g, _block(w_, lo, hi)),
              f"channel_block: {what} of the backward kernel on channels "
              f"[{lo}, {hi}) differs from that block of its full-C launch")
    for g, w_, what in zip(got[2:], whole[2:], ("da", "db")):
        check(torch.equal(g, _block(w_, lo, hi)),
              f"channel_block: {what} of the backward kernel on channels "
              f"[{lo}, {hi}) differs from that block of its full-C launch "
              f"(max abs {float((g - _block(w_, lo, hi)).abs().max())})")
    emit("kernel_bwd", case="channel_block", shape=[n, f, h, w, c], R=1,
         S=5, channels=[lo, hi], dtype="bfloat16",
         dy_dident_bit_equal_to_full_c=True, da_db_bit_equal_to_full_c=True)


def serve_phase(dev, card: str, use_pallas_dw: bool = False) -> dict:
    """The flagship eval step, 4 requests of 8 clips after one warm-up, then
    the same weights and first batch through the plain route: the
    composition (fused_tpool=False) or, with use_pallas_dw, the depthwise op
    patched to its plain version. Returns the launches and, with the flag,
    the (shape, stride) of every depthwise layer of one batch, in order."""
    label = "serve_dw" if use_pallas_dw else "serve"
    cfg = flagship_cfg()
    cfg.model.use_pallas_dw = use_pallas_dw
    batch, s = 8, cfg.model.num_segments
    num_classes = cfg.model.num_classes
    model, name = build_model(cfg)
    step = make_adamml_eval_step(model)
    state = EvalState()
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [(example_inputs(cfg, batch=batch, seed=100 + k),
                torch.randint(0, num_classes, (batch,), generator=gen,
                              device=dev)) for k in range(5)]
    layers = []  # (input shape, stride) of each depthwise call, batch 0
    hooks = [m.register_forward_hook(
        lambda mod, args, out: layers.append((tuple(args[0].shape),
                                              mod.strides)))
        for m in model.modules() if isinstance(m, _DepthwiseConv)]
    want_dw = DW_STEP["eval"] if use_pallas_dw else (0, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: counts zeroed just before, read just after
    zero_counts()
    latencies, first = [], None
    for i, (inputs, target) in enumerate(batches):
        before = all_counts()
        t0 = time.perf_counter()
        logits, decisions, loss = step(state, inputs, target, seed=i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(tuple(logits.shape) == (batch, num_classes)
              and logits.dtype == torch.float32, f"logits {logits.shape}")
        check(bool(torch.isfinite(logits).all()) and
              math.isfinite(float(loss)), "non-finite logits or loss")
        check(tuple(decisions.shape) == (batch, s, 2),
              f"decisions {decisions.shape}")
        check(set(decisions.unique().tolist()) <= {0.0, 1.0},
              "decisions outside {0, 1}")
        fwd = tp.launch_counts[tp.KERNEL] - before[tp.KERNEL]
        check(fwd == 3 and dw_launches(before) == want_dw,
              f"batch {i}: {fwd} epilogue and {dw_launches(before)} "
              f"depthwise launches, expected 3 (stage boundaries 1-3) and "
              f"{want_dw}")
        if i == 0:
            first = (logits, decisions)
            for h in hooks:
                h.remove()
        else:  # batch 0 is the warm-up
            latencies.append(dt)
    launches = all_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    # the kernels one eval step puts on the card (after the counted run)
    step_kernels = len(_device_kernels(
        lambda: step(state, batches[1][0], batches[1][1], seed=9)))
    emit(label, arch=name, card=card, batch_clips=batch,
         requests=len(latencies), warmup=1, kernels_per_step=step_kernels,
         latency_ms=[x * 1e3 for x in latencies],
         clips_per_s=[batch / x for x in latencies],
         max_memory_allocated_bytes=peak, launches=launches,
         selection_rate=float(first[1].mean()),
         timing="host clock around each step, ending in "
                "torch.cuda.synchronize()")

    # the same batch and weights through the plain route
    if use_pallas_dw:
        real = dwk._launch
        dwk._launch = (lambda x, w, sc, b, stride, relu6, key=dwk.KERNEL,
                       flip=False: dwk.reference_impl(
                           x, w.flip(0, 1) if flip else w, sc, b, stride,
                           relu6))
        plain, route = model, "depthwise op patched to reference_impl"
    else:
        cfg_plain = flagship_cfg()
        cfg_plain.model.fused_tpool = False
        plain, _ = build_model(cfg_plain)
        plain.load_state_dict(model.state_dict())
        route = "fused_tpool=False"
    before = all_counts()
    try:
        p_logits, p_dec, _ = make_adamml_eval_step(plain)(
            state, batches[0][0], batches[0][1], seed=0)
        torch.cuda.synchronize()
    finally:
        if use_pallas_dw:
            dwk._launch = real
    after = all_counts()
    if use_pallas_dw:
        check(dw_launches(before) == (0, 0), "the plain route launched the "
              "depthwise kernel")
    else:
        check(after == before, "the plain composition launched a kernel")
    scale = float(first[0].abs().max())
    diff = float((p_logits - first[0]).abs().max())
    # each stage boundary rounds to bf16 once in the kernel and twice in the
    # composition (after the BN apply and after the add): up to 1 bf16 ulp
    # (2^-8 relative) apart, which the later layers carry to the logits;
    # 2% of the largest logit (about 5 ulps) bounds it. The depthwise
    # kernel rounds where its plain version does, so there the two are
    # expected equal.
    tol = 0.02 * max(scale, 1.0)
    check(torch.equal(p_dec, first[1]), f"decisions differ from the plain "
          f"route ({route})")
    check(diff <= tol, f"logits differ from the plain route ({route}) by "
          f"{diff} > {tol}")
    emit(label + "_vs_plain", route=route, max_abs_logit=scale,
         max_abs_diff=diff, tolerance=tol, decisions_equal=True)
    del plain, model, step, batches
    torch.cuda.empty_cache()
    return {"launches": launches, "dw_layers": layers,
            "kernels_per_step": step_kernels}


def _train_state(model, cfg) -> TrainState:
    return TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))


def _flags(phase: str) -> StageFlags:
    return (StageFlags.main_phase() if phase == "main"
            else StageFlags.policy_phase())


def _make_step(model, phase):
    return make_adamml_train_step(model, flags=_flags(phase),
                                  penalty_type="blockdrop", gammas=GAMMAS,
                                  clip_gradient=None)


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_phase(dev, card: str, use_pallas_dw: bool = False) -> dict:
    """The flagship train step at full width: the main phase, then the
    policy phase, on one model and state, as the alternating curriculum
    runs them. Returns each phase's launches, and under "peak" each
    phase's max_memory_allocated."""
    label = "train_dw" if use_pallas_dw else "train"
    cfg = flagship_cfg()
    cfg.model.use_pallas_dw = use_pallas_dw
    batch, s = 8, cfg.model.num_segments
    num_classes = cfg.model.num_classes
    model, name = build_model(cfg)
    state = _train_state(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = [(example_inputs(cfg, batch=batch, seed=200 + k),
                torch.randint(0, num_classes, (batch,), generator=gen,
                              device=dev)) for k in range(4)]
    seen = []  # decisions of every step, from the policy net's output
    hook = model.policy_net.register_forward_hook(
        lambda mod, args, out: seen.append(out[0].detach()))
    out = {}
    for phase in ("main", "policy"):
        step = _make_step(model, phase)
        want_bwd = 3 if phase == "main" else 0
        want_dw = DW_STEP[phase] if use_pallas_dw else (0, 0)
        start = _snapshot(model)
        # what this phase holds beyond one step's batch, which a single
        # step (tools/mem_analysis.py) does not: the other batches and the
        # snapshot
        held = sum(t.numel() * t.element_size() for t in start.values()) + \
            sum(t.numel() * t.element_size() for inputs, target in
                batches[1:] for t in list(inputs) + [target])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # this path: counts zeroed just before, read just after
        zero_counts()
        bn_calls, bn_hooks = bn_call_hooks(model)
        latencies, losses = [], []
        for i, (inputs, target) in enumerate(batches):
            before = all_counts()
            t0 = time.perf_counter()
            m = step(state, inputs, target, LR, P_LR, COST, seed=i)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            vals = {k: float(m[k]) for k in ("loss", "cls_loss",
                                             "policy_loss")}
            check(all(math.isfinite(v) for v in vals.values()),
                  f"{phase} step {i}: non-finite losses {vals}")
            fwd = tp.launch_counts[tp.KERNEL] - before[tp.KERNEL]
            bwd = tp.launch_counts[tp.KERNEL_BWD] - before[tp.KERNEL_BWD]
            check(fwd == 3 and bwd == want_bwd,
                  f"{phase} step {i}: {fwd} forward and {bwd} backward "
                  f"epilogue launches, expected 3 and {want_bwd}")
            check(dw_launches(before) == want_dw,
                  f"{phase} step {i}: {dw_launches(before)} depthwise "
                  f"(forward, input-gradient) launches, expected {want_dw}")
            check(set(seen[-1].unique().tolist()) <= {0.0, 1.0},
                  f"{phase} step {i}: decisions outside {{0, 1}}")
            losses.append(vals)
            if i:  # step 0 is the warm-up
                latencies.append(dt)
        launches = all_counts()
        for h in bn_hooks:
            h.remove()
        check(bn_counts(launches) == bn_launches(bn_calls),
              f"{phase}: {len(batches)} steps launched the BN kernels "
              f"{bn_counts(launches)}, their train-mode BN calls "
              f"{bn_launches(bn_calls)}")
        peak = torch.cuda.max_memory_allocated(dev)
        end = _snapshot(model)
        params = dict(model.named_parameters())
        live = f"{phase}_net."
        moved = {"live": 0, "live_total": 0, "frozen": 0, "stats_main": 0,
                 "stats_policy": 0}
        for k in params:
            changed = not torch.equal(start[k], end[k])
            if k.startswith(live):
                moved["live"] += changed
                moved["live_total"] += 1
            else:
                moved["frozen"] += changed
        for k in start:
            if k.endswith("running_mean") and not torch.equal(start[k],
                                                             end[k]):
                moved["stats_" + k.split("_net.")[0]] += 1
        check(moved["frozen"] == 0, f"{phase}: {moved['frozen']} frozen "
                                    "parameters moved")
        check(moved["live"] == moved["live_total"],
              f"{phase}: only {moved['live']} of {moved['live_total']} live "
              "parameters moved")
        check(moved["stats_main"] > 0 and moved["stats_policy"] > 0,
              f"{phase}: BN statistics of a subnet did not move: {moved}")
        emit(label, curriculum_phase=phase, arch=name, card=card,
             batch_clips=batch,
             steps=len(latencies), warmup=1,
             latency_ms=[x * 1e3 for x in latencies],
             clips_per_s=[batch / x for x in latencies],
             max_memory_allocated_bytes=peak, held_besides_batch_bytes=held,
             launches=launches, bn_calls=sum(bn_calls.values()),
             losses=losses, moved=moved,
             selection_rate=float(torch.stack(seen[-4:]).mean()),
             timing="host clock around each step, ending in "
                    "torch.cuda.synchronize()")
        out[phase] = launches
        out.setdefault("peak", {})[phase] = peak
        out.setdefault("held", {})[phase] = held
    hook.remove()
    del model, state, batches, seen
    torch.cuda.empty_cache()
    return out


def _updates(model, start, prefix):
    return {k: p.detach() - start[k] for k, p in model.named_parameters()
            if k.startswith(prefix)}


def _rel(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over a dict of tensors."""
    num = sum(float((a[k] - b[k]).float().norm() ** 2) for k in b)
    return (num / sum(float(v.float().norm() ** 2) for v in b.values())) ** .5


def train_vs_plain_phase(dev) -> None:
    """One main-phase step through the fused kernels (A) and one through the
    plain composition (fused_tpool=False, B), same weights, batch and seeds,
    and, for a noise floor, the composition on the batch changed at the
    bf16 rounding level (C: each input times 1 + 2^-9 u, u uniform in
    [-1, 1]). Each stage boundary rounds to bf16 once in the kernel and
    twice in the composition (up to 1 bf16 ulp apart), so A is B perturbed
    at the rounding level. Checked: the losses within 1%; the classifier
    heads' updates (features times the loss gradient) within 5% of their
    norm; the whole main net's update no further from B than twice C's
    distance from B plus 2%. The deeper layers' gradient at random init
    amplifies rounding-level changes (C measures by how much)."""
    cfg = flagship_cfg()
    model, _ = build_model(cfg)
    cfg_plain = flagship_cfg()
    cfg_plain.model.fused_tpool = False
    start = _snapshot(model)
    inputs = example_inputs(cfg, batch=8, seed=300)
    gen = torch.Generator(device=dev).manual_seed(301)
    nudged = [x * (1 + 2.0 ** -9 * (2 * torch.rand(
        x.shape, generator=gen, device=dev) - 1)) for x in inputs]
    target = torch.arange(8, device=dev) % cfg.model.num_classes
    res = {}
    for label, x in (("fused", inputs), ("plain", inputs),
                     ("plain_nudged", nudged)):
        if label != "fused":
            model, _ = build_model(cfg_plain)
            model.load_state_dict(start)
        counts = dict(tp.launch_counts)
        out = _make_step(model, "main")(_train_state(model, cfg), x, target,
                                        LR, P_LR, COST, seed=0)
        torch.cuda.synchronize()
        res[label] = (float(out["loss"]),
                      _updates(model, start, "main_net."),
                      [tp.launch_counts[k] - counts[k]
                       for k in (tp.KERNEL, tp.KERNEL_BWD)])
        del model
    launched = {k: v[2] for k, v in res.items()}
    check(launched == {"fused": [3, 3], "plain": [0, 0],
                       "plain_nudged": [0, 0]},
          f"kernel launches by run: {launched}")
    loss = {k: abs(v[0] - res["plain"][0]) / abs(res["plain"][0])
            for k, v in res.items()}
    head = {k: {n: u for n, u in v[1].items()
                if n.endswith(("fc.weight", "fc.bias", "classifier.weight",
                               "classifier.bias", "lf_weights"))}
            for k, v in res.items()}
    head_rel = {k: _rel(head[k], head["plain"]) for k in head}
    upd_rel = {k: _rel(v[1], res["plain"][1]) for k, v in res.items()}
    check(loss["fused"] <= 0.01, f"loss differs from the plain composition "
                                 f"by {loss['fused']} relative > 0.01")
    check(head_rel["fused"] <= 0.05, f"head updates differ by "
                                     f"{head_rel['fused']} of their norm")
    limit = 2 * upd_rel["plain_nudged"] + 0.02
    check(upd_rel["fused"] <= limit,
          f"main-net updates differ from the plain composition by "
          f"{upd_rel['fused']} of their norm > {limit} (noise floor "
          f"{upd_rel['plain_nudged']})")
    emit("train_vs_plain", loss={k: v[0] for k, v in res.items()},
         loss_rel_diff=loss, head_update_rel_diff=head_rel,
         update_rel_diff=upd_rel,
         tolerance={"loss": 0.01, "head": 0.05,
                    "updates": "2 x plain_nudged + 0.02"})
    del res, head
    torch.cuda.empty_cache()


# the multi-step dispatch's K and its kernels' names in a device trace
K_DISPATCH = 2
FWD_NAME, BWD_NAME, DW_NAME = ("tpool_fused_kernel", "tpool_fused_bwd_kernel",
                               "dw3x3_kernel")


def _train_snapshot(model, state) -> tuple:
    """Parameters, BN statistics, both optimizers' state and the step."""
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            [{p: {k: v.clone() for k, v in st.items()}
              for p, st in opt.state.items()}
             for opt in (state.main_opt, state.policy_opt)], state.step)


def _train_restore(model, state, snap) -> None:
    """Back to ``snap`` in place: the same tensors, so a captured graph's
    addresses stay valid."""
    model.load_state_dict(snap[0])
    for opt, saved in zip((state.main_opt, state.policy_opt), snap[1]):
        check(set(opt.state) == set(saved), "optimizer state changed keys")
        for p, st in opt.state.items():
            for k, v in st.items():
                v.copy_(saved[p][k])
    state.step = snap[2]


def _snapshot_diff(a, b) -> dict:
    """Tensors of two snapshots that differ, and the largest difference."""
    pairs = [(f"model.{k}", a[0][k], b[0][k]) for k in a[0]]
    for i, (sa, sb) in enumerate(zip(a[1], b[1])):
        pairs += [(f"opt{i}.{k}", v, sb[p][k]) for p, st in sa.items()
                  for k, v in st.items()]
    bad = [(n, float((x.float() - y.float()).abs().max()))
           for n, x, y in pairs if not torch.equal(x, y)]
    return {"tensors": len(pairs), "unequal": len(bad),
            "max_abs_diff": max((d for _, d in bad), default=0.0),
            "steps": [a[2], b[2]], "first_unequal": [n for n, _ in bad[:3]]}


def _stacked_batches(cfg, k, batch, seed, dev):
    xs = [example_inputs(cfg, batch=batch, seed=seed + i) for i in range(k)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return ([torch.stack([x[m] for x in xs]) for m in range(len(xs[0]))],
            torch.randint(0, cfg.model.num_classes, (k, batch),
                          generator=gen, device=dev))


def _replay_vs_eager(cfg, phase, batch, dev, label, card=None) -> dict:
    """One model, one K-step multi-step: a first dispatch (K single steps:
    it makes the optimizers' state), a snapshot, the second dispatch
    (capture and the first replay), then from the snapshot K calls of
    make_adamml_train_step, the plain single step that K = 1 runs. Both
    must leave the same parameters, BN statistics, optimizer state, step
    and metrics, bit for bit. With ``card``, also the timings, the device
    trace of one replay and of K single steps, and peak memory.
    Float32 cuDNN convolutions at the tiny config's shapes pick algorithms
    whose sums vary from run to run (two eager runs differ), so tiny
    configs run with cudnn.deterministic; the flagship's bf16 runs are
    bit-reproducible as they are."""
    k = K_DISPATCH
    model, name = build_model(cfg)
    state = _train_state(model, cfg)
    multi = make_adamml_multi_step(model, flags=_flags(phase),
                                   penalty_type="blockdrop", gammas=GAMMAS,
                                   clip_gradient=None)
    single = make_adamml_train_step(model, flags=_flags(phase),
                                    penalty_type="blockdrop", gammas=GAMMAS,
                                    clip_gradient=None)

    def eager(state, xs, ts, lr, p_lr, cost_weights, seed):
        ms = [single(state, [x[s] for x in xs], ts[s], lr, p_lr,
                     cost_weights, seed) for s in range(k)]
        return {n: torch.stack([m[n] for m in ms]) for n in ms[0]}

    x1, t1 = _stacked_batches(cfg, k, batch, 400, dev)
    x2, t2 = _stacked_batches(cfg, k, batch, 500, dev)
    args = (LR, P_LR, COST)
    multi(state, x1, t1, *args, 3)
    torch.cuda.synchronize()
    check(multi.eager_dispatches == 1 and multi.replays == 0,
          f"{label} {phase}: the first dispatch did not run eagerly")
    snap = _train_snapshot(model, state)
    torch.cuda.reset_peak_memory_stats(dev)
    # this path: counts zeroed just before, read just after; a capture
    # counts its launches once, a replay not at all (the trace below
    # counts the replayed kernels)
    zero_counts()
    replayed = multi(state, x2, t2, *args, 4)
    torch.cuda.synchronize()
    launches = all_counts()
    check(multi.replays == 1, f"{label} {phase}: no replay")
    got = _train_snapshot(model, state)
    _train_restore(model, state, snap)
    singles = eager(state, x2, t2, *args, 4)
    torch.cuda.synchronize()
    want = _train_snapshot(model, state)
    diff = _snapshot_diff(got, want)
    mdiff = {n: float((replayed[n].float() - singles[n].float()).abs().max())
             for n in singles}
    check(diff["unequal"] == 0 and not any(mdiff.values()),
          f"{label} {phase}: replay differs from {k} single steps: {diff}, "
          f"metrics {mdiff}")
    check(all(bool(torch.isfinite(v).all()) for v in replayed.values()),
          f"{label} {phase}: non-finite metrics")
    line = dict(curriculum_phase=phase, arch=name, K=k, batch_clips=batch,
                replay_vs_single_steps=diff, metrics_max_abs_diff=mdiff,
                loss=replayed["loss"].tolist(),
                capture_launches=launches)
    # the kernels one replay and K single steps put on the card
    _train_restore(model, state, snap)
    rk, r_wall = _device_trace(lambda: multi(state, x2, t2, *args, 4))
    _train_restore(model, state, snap)
    ek, e_wall = _device_trace(lambda: eager(state, x2, t2, *args, 4))
    names = {"replay": [n for n, _, _ in rk], "eager": [n for n, _, _ in ek]}
    per = {kind: {"forward": sum(FWD_NAME in n and BWD_NAME not in n
                                 for n in ns),
                  "backward": sum(BWD_NAME in n for n in ns),
                  "depthwise": sum(DW_NAME in n for n in ns),
                  "kernels": len(ns)} for kind, ns in names.items()}
    # one epilogue at each stage boundary that pools frames: 3 at the
    # flagship's 8 frames, 2 at the tiny config's 4
    pools = sum(cfg.model.groups >> i > 1 for i in range(3))
    want_bwd = pools * k if phase == "main" else 0
    dw_step = DW_STEP[phase] if cfg.model.use_pallas_dw else (0, 0)
    for kind in ("replay", "eager"):
        check(per[kind]["forward"] == pools * k
              and per[kind]["backward"] == want_bwd
              and per[kind]["depthwise"] == k * sum(dw_step),
              f"{label} {phase} {kind}: kernels {per[kind]}, expected "
              f"{pools * k} forward, {want_bwd} backward epilogue and "
              f"{k * sum(dw_step)} depthwise kernels")
    line.update(trace_kernels=per)
    if card is not None:
        peak = torch.cuda.max_memory_allocated(dev)
        times = {"replay": [], "eager": []}
        host = {"replay": [], "eager": []}
        for rep in range(4):
            for kind, fn in (("eager", eager), ("replay", multi)):
                _train_restore(model, state, snap)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(state, x2, t2, *args, 4)
                t1_ = time.perf_counter()
                torch.cuda.synchronize()
                t2_ = time.perf_counter()
                if rep:  # rep 0 is the warm-up
                    times[kind].append((t2_ - t0) / k * 1e3)
                    host[kind].append((t1_ - t0) * 1e3)
        line.update(
            card=card, median_ms_per_step={
                kd: float(np.median(v)) for kd, v in times.items()},
            ms_per_step=times, host_ms_per_dispatch=host,
            device_idle_share={"replay": _idle_share(rk, r_wall),
                               "eager": _idle_share(ek, e_wall)},
            max_memory_allocated_bytes_with_graph_pool=peak,
            timing="host clock around one dispatch of K steps ending in "
                   "torch.cuda.synchronize(), per step; 3 of each after "
                   "1 warm-up, K single steps and replay in turns from one "
                   "snapshot; host_ms_per_dispatch until the call "
                   "returns; idle share from the torch.profiler trace of "
                   "one dispatch")
    emit(label, **line)
    out = {"capture": launches, "trace": per}
    del multi, single, model, state, snap, got, want
    torch.cuda.empty_cache()
    return out


def multi_step_phase(dev, card: str) -> dict:
    """The multi-step dispatch (make_adamml_multi_step, K = 2 steps as one
    replayed CUDA graph) of the flagship at full width, bf16, 8 clips a
    step, in both curriculum phases: replay against K single steps
    (make_adamml_train_step) from one snapshot (bit for bit), each with
    its kernels counted
    in a device trace (3 forward and, in the main phase, 3 backward
    epilogue kernels a step), with ms per step, host ms per dispatch,
    device idle share and peak memory. Then the tiny float32 config with
    use_pallas_dw=True (the policy phase: the trunks' remat under capture),
    so the depthwise kernel is seen in a replay too."""
    out = {}
    for phase in ("main", "policy"):
        out[phase] = _replay_vs_eager(flagship_cfg(), phase, 8, dev,
                                      "multi_step", card)
    tiny = flagship_cfg(tiny=True)
    tiny.model.use_pallas_dw = True
    torch.backends.cudnn.deterministic = True
    try:
        out["tiny_dw_policy"] = _replay_vs_eager(tiny, "policy", 4, dev,
                                                 "multi_step_tiny_dw")
    finally:
        torch.backends.cudnn.deterministic = False
    return out


# (eval_capacity, capacity_groups) of the eval_capacity phase
CAPACITIES = [(1.0, 1), (0.5, 1), (0.25, 1), (0.5, 2)]


def _packed_rows(fn) -> tuple:
    """(the row counts N of the forward epilogue's kernel launches in
    ``fn``, what ``fn`` returns); measurement only: the launcher is
    wrapped while ``fn`` runs."""
    rows, real = [], tp._launch

    def launch(y, *args):
        rows.append(int(y.shape[0]))
        return real(y, *args)
    tp._launch = launch
    try:
        out = fn()
    finally:
        tp._launch = real
    return rows, out


def eval_capacity_phase(dev, card: str) -> dict:
    """Eval-capacity conditional compute at full width (bf16, 8 clips x 5
    segments = 40 rows): capacity 1.0, 0.5 and 0.25 in one block and 0.5 in
    two. For each: the main net with decisions forced to select at most
    cap rows a block against the unpacked net's masked logits on the same
    weights; the flagship eval step's ms (real decisions); validate's
    capacity_dropped against a count made here; and the forward epilogue
    kernel against its plain version at the packed row counts."""
    base_cfg = flagship_cfg()
    base, name = build_model(base_cfg)
    s = base_cfg.model.num_segments
    batch = 8
    rows = batch * s
    x = example_inputs(base_cfg, batch=batch, seed=600)
    m_x = [a.reshape((rows,) + tuple(a.shape[2:])) for a in x]
    gen = torch.Generator(device=dev).manual_seed(601)
    target = torch.randint(0, base_cfg.model.num_classes, (batch,),
                           generator=gen, device=dev)
    launches = {}
    for c, g in CAPACITIES:
        label = f"c{c}_G{g}"
        cfg = flagship_cfg()
        cfg.model.eval_capacity, cfg.model.capacity_groups = c, g
        model, _ = build_model(cfg)
        model.load_state_dict(base.state_dict())
        bl = rows // g
        cap = max(1, int(round(c * bl)))
        # forced decisions: in each block a seeded choice of at most cap
        # rows per modality (cap - 1 in the second modality)
        dec = torch.zeros((2, rows), device=dev)
        for m in range(2):
            for b in range(g):
                pick = torch.randperm(bl, generator=gen, device=dev)[
                    :max(1, min(cap, bl) - m)]
                dec[m, b * bl + pick] = 1.0
        with torch.no_grad():
            zero_counts()
            got_rows, packed = _packed_rows(
                lambda: model.main_net(m_x, dec, seq_groups=s))
            launches[label] = all_counts()
            want = base.main_net(m_x, dec, seq_groups=s)
        torch.cuda.synchronize()
        n_run = rows if c >= 1.0 else g * cap
        check(got_rows == [n_run] * 3, f"{label}: epilogue launches on rows "
              f"{got_rows}, expected 3 on {n_run}")
        scale = float(want.abs().max())
        diff = float((packed - want).abs().max())
        # the backbone on fewer rows: cuDNN may pick other algorithms for
        # another batch, which sum in another order and round to bf16 at
        # other places; 2% of the largest logit, serve_vs_plain's bound
        tol = 0.02 * max(scale, 1.0)
        check(bool(torch.isfinite(packed).all()) and diff <= tol,
              f"{label}: packed logits differ from the masked unpacked "
              f"ones by {diff} > {tol}")
        # the eval step with the policy's real decisions
        step = make_adamml_eval_step(model)
        lat, drops = [], []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, decisions, loss = step(EvalState(), x, target, seed=i)
            torch.cuda.synchronize()
            if i:
                lat.append((time.perf_counter() - t0) * 1e3)
            check(bool(torch.isfinite(logits).all()), f"{label}: logits")
        # validate's count against one made here from the same decisions
        batches = [0, 1]
        v = validate(batches, lambda b: (x, target), step, EvalState(),
                     seed=11, modality=["rgb", "sound"], adamml=True,
                     num_segments=s, eval_capacity=c, capacity_groups=g)
        host = [0, 0]
        for sel in np.split(v["all_selections"], len(batches)):
            flat = sel.reshape(rows, 2)
            for m in range(2):
                for b in range(g):
                    on = int(flat[b * bl:(b + 1) * bl, m].sum())
                    host[m] += max(0, on - cap) if c < 1.0 else 0
        counted = v.get("capacity_dropped", {"rgb": 0, "sound": 0})
        check([counted["rgb"], counted["sound"]] == host,
              f"{label}: capacity_dropped {counted}, counted here {host}")
        emit("eval_capacity", card=card, arch=name, eval_capacity=c,
             capacity_groups=g, rows=rows, cap_per_block=cap,
             backbone_rows=n_run, forced_max_abs_logit=scale,
             forced_max_abs_diff=diff, tolerance=tol,
             eval_latency_ms=lat, median_ms=float(np.median(lat)),
             selection_rate=float(decisions.mean()),
             capacity_dropped=counted, host_count=host,
             launches=launches[label],
             timing="host clock around one eval step of 8 clips ending in "
                    "torch.cuda.synchronize(), 4 after 1 warm-up")
        del model, step
        torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    return {"launches": launches, "kernel": kernel_packed_rows(dev)}


def kernel_packed_rows(dev) -> dict:
    """The forward epilogue kernel against its plain version at the three
    stage boundaries on the packed row counts of eval capacity 0.5 and
    0.25 (N = 20 and 10, bf16, eval affine R = S = 1), with CUDA-event
    times beside the bound, as kernel_phase times N = 40."""
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = l2_flush_buffer(dev)
    res = {}
    for n in (20, 10):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "max_abs_err": 0.0}
        for stage, (f, h, w, c) in enumerate(
                [(8, 56, 56, 256), (4, 28, 28, 512), (2, 14, 14, 1024)], 1):
            y = torch.randn((n, f, h, w, c), generator=gen,
                            device=dev).to(torch.bfloat16)
            ident = torch.randn((n, f, h, w, c), generator=gen,
                                device=dev).to(torch.bfloat16)
            a = 1.0 + 0.3 * torch.randn((1, 1, c), generator=gen, device=dev)
            b = 0.1 * torch.randn((1, 1, c), generator=gen, device=dev)
            got = tp.fused_bn_add_relu_tpool(y, ident, a, b)
            want = tp.reference_impl(y, ident, a, b)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            check(within_one_bf16_ulp(got, want), f"packed N={n} stage "
                  f"{stage}: kernel beyond 1 bf16 ulp (max abs err {err})")
            nbytes, ops = tpool_work(n, f, h, w, c, 2)
            bound, by = bound_ms(nbytes, ops)
            k_ms = event_ms(lambda: tp.fused_bn_add_relu_tpool(
                y, ident, a, b), flush=flush)
            p_ms = event_ms(lambda: tp.reference_impl(y, ident, a, b),
                            flush=flush)
            emit("kernel_packed", case=f"N{n}_stage{stage}",
                 shape=[n, f, h, w, c], dtype="bfloat16", max_abs_err=err,
                 tolerance="1 bf16 ulp", kernel_ms=k_ms, plain_ms=p_ms,
                 bound_ms=bound, bound_by=by, share_of_bound=bound / k_ms,
                 library_ms=None,
                 timing="CUDA events, mean of 20 after 3 warm-up, L2 "
                        "flushed between launches")
            tot["ms"] += k_ms
            tot["plain_ms"] += p_ms
            tot["bound_ms"] += bound
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            del y, ident, got, want
        tot["share_of_bound"] = tot["bound_ms"] / tot["ms"]
        res[f"N{n}"] = tot
    return res


def _st_zero_noise(generator, logits, tau):
    """Zero-noise straight-through decision: no generator stream."""
    y = torch.softmax(logits / tau, dim=-1)
    hard = (logits.argmax(-1) == 1).float()
    return hard + y[..., 1] - y[..., 1].detach()


def tiny_train_phase(dev, use_pallas_dw: bool = False) -> None:
    """One float32 step of each phase from the same weights, on the card
    and on the CPU: 8 clips at 64x64 (at fewer samples per BN group the
    tiny model's gradient is ill-conditioned), dropout 0, zero-noise
    decisions, TF32 off. Losses within 1e-3 relative; SGD updates each
    within 0.1 * lr; 99% of the Adam updates within 0.1 * p_lr (Adam maps
    each gradient element to about +-p_lr, so elements within float32
    noise of 0 may take either sign). With use_pallas_dw the card's step
    launches the depthwise kernel as the flagship's does."""
    cfg = flagship_cfg(tiny=True)
    cfg.model.use_pallas_dw = use_pallas_dw
    cfg.model.dropout = 0.0
    cfg.data.input_size = 64
    x = example_inputs(cfg, batch=8, device="cpu", seed=5)
    target = torch.arange(8) % cfg.model.num_classes
    cpu, _ = build_model(cfg, device="cpu")
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    real = tpolicy.gumbel_decision
    tpolicy.gumbel_decision = _st_zero_noise
    line = {}
    try:
        for phase in ("main", "policy"):
            out = {}
            for d in (dev, torch.device("cpu")):
                model, _ = build_model(cfg, device=d)
                model.load_state_dict(start)
                before = all_counts()
                m = _make_step(model, phase)(
                    _train_state(model, cfg), [a.to(d) for a in x],
                    target.to(d), LR, P_LR, COST, seed=0)
                if d.type == "cuda":
                    want = DW_STEP[phase] if use_pallas_dw else (0, 0)
                    check(dw_launches(before) == want,
                          f"tiny {phase}: {dw_launches(before)} depthwise "
                          f"launches, expected {want}")
                out[d.type] = (float(m["loss"]),
                               {k: v.cpu() for k, v in
                                model.state_dict().items()})
            loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(
                out["cpu"][0])
            lr = LR if phase == "main" else P_LR
            close = total = worst = 0
            for k, _ in cpu.named_parameters():
                if not k.startswith(f"{phase}_net."):
                    continue
                diff = (out["cuda"][1][k] - out["cpu"][1][k]).abs()
                worst = max(worst, float(diff.max()))
                close += int((diff <= 0.1 * lr).sum())
                total += diff.numel()
            check(loss_rel <= 1e-3, f"tiny {phase}: loss card vs CPU "
                                    f"{loss_rel} relative > 1e-3")
            check(close == total if phase == "main" else
                  close >= 0.99 * total,
                  f"tiny {phase}: {total - close} of {total} updates off "
                  f"by more than 0.1 * lr (largest {worst})")
            line[phase] = dict(loss_rel_diff=loss_rel,
                               max_abs_update_diff=worst,
                               share_within_0p1_lr=close / total)
    finally:
        tpolicy.gumbel_decision = real
    emit("tiny_dw_train" if use_pallas_dw else "tiny_train", **line)


def tiny_reference_phase(dev, use_pallas_dw: bool = False) -> None:
    """Tiny float32 config: the policy logits and the decision-masked main
    net on the card against the same weights on the CPU."""
    cfg = flagship_cfg(tiny=True)
    cfg.model.use_pallas_dw = use_pallas_dw
    gpu, _ = build_model(cfg)
    cpu, _ = build_model(cfg, device="cpu")
    x_cpu = example_inputs(cfg, batch=4, device="cpu", seed=3)
    n, s = x_cpu[0].shape[:2]
    size = cfg.model.policy_input_size
    dec = (torch.arange(2 * n * s) % 3 != 0).float().reshape(2, n * s)
    outs = []
    before = all_counts()
    for model, x, d in ((gpu, [a.to(dev) for a in x_cpu], dec.to(dev)),
                        (cpu, x_cpu, dec)):
        with torch.no_grad():
            _, p_logits = model.policy_net(
                [policy_stream(x[0], size), x[1]], 5.0)
            m_logits = model.main_net(
                [a.reshape((n * s,) + tuple(a.shape[2:])) for a in x], d,
                seq_groups=s)
        outs.append((p_logits.cpu(), m_logits.cpu()))
    want = DW_STEP["eval"] if use_pallas_dw else (0, 0)
    check(dw_launches(before) == want, f"tiny forward: "
          f"{dw_launches(before)} depthwise launches, expected {want}")
    errs = [float((g - c).abs().max()) for g, c in zip(*outs)]
    # float32 with TF32 off: cuDNN and the CPU sum in other orders
    check(max(errs) <= 1e-3, f"card vs CPU at the tiny config: {errs}")
    emit("tiny_dw_reference" if use_pallas_dw else "tiny_reference",
         policy_logits_err=errs[0],
         main_logits_err=errs[1], tolerance=1e-3)


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


def _dw_inputs(shape, dtype, gen, dev, affine=False):
    """x, the taps as _DepthwiseConv passes them (a (3, 3, C) view of a
    (C, 1, 3, 3) weight in x's dtype) and, with ``affine``, scale and
    bias."""
    b, h, w, c = shape
    x = (2.0 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    weight = 0.3 * torch.randn((c, 1, 3, 3), generator=gen, device=dev)
    taps = weight.to(dtype)[:, 0].permute(1, 2, 0)
    if not affine:
        return x, taps, None, None
    return (x, taps, 1.0 + 0.3 * torch.randn(c, generator=gen, device=dev),
            0.5 * torch.randn(c, generator=gen, device=dev))


def _dw_check(label, got, want, dtype) -> float:
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    if dtype == torch.bfloat16:
        ok, tol = within_one_bf16_ulp(got, want), "1 bf16 ulp"
    else:
        ok = bool(((got - want).abs() <= 1e-6 * want.abs()).all())
        tol = "1e-6 relative"
    check(ok, f"{label}: depthwise kernel disagrees with its plain version "
              f"beyond {tol} (max abs err {err})")
    return err


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


def _device_kernels(fn) -> list:
    """Names of the kernels ``fn`` puts on the card (``_device_trace``)."""
    return [k[0] for k in _device_trace(fn)[0]]


def _idle_share(kernels, wall_us: float) -> float:
    """1 - (the union of the kernels' intervals) / the calls' host span."""
    busy, end = 0.0, float("-inf")
    for _, t0, dur in sorted(kernels, key=lambda k: k[1]):
        if t0 + dur > end:
            busy += t0 + dur - max(t0, end)
            end = t0 + dur
    return 1.0 - busy / wall_us


# (label, (B, H, W, C), stride, dtype, affine with ReLU6): float32, odd
# sizes, stride 2 on an even size (pads (0, 1)), the affine with ReLU6,
# C % 8 != 0 (4 channels a thread, and an element copy at C = 12 in bf16),
# and sizes that cross the tiles' edges: one row, one column, one image,
# H and W no multiple of a tile, C = 8 and 960
DW_EXTRA_CASES = [
    ("f32_9x11_s1", (4, 9, 11, 32), 1, torch.float32, False),
    ("f32_9x11_s2", (4, 9, 11, 32), 2, torch.float32, False),
    ("bf16_6x6_s2", (4, 6, 6, 24), 2, torch.bfloat16, False),
    ("f32_6x6_s2_affine_relu6", (4, 6, 6, 24), 2, torch.float32, True),
    ("bf16_affine_relu6_s1", (8, 20, 20, 96), 1, torch.bfloat16, True),
    ("bf16_affine_relu6_s2", (8, 20, 20, 96), 2, torch.bfloat16, True),
    ("bf16_C12_s1", (4, 7, 9, 12), 1, torch.bfloat16, True),
    ("f32_C12_s2", (4, 7, 9, 12), 2, torch.float32, True),
    ("bf16_H1_C8_s1", (3, 1, 37, 8), 1, torch.bfloat16, False),
    ("bf16_W1_C24_s2", (3, 35, 1, 24), 2, torch.bfloat16, True),
    ("f32_B1_1x1_C960_s1", (1, 1, 1, 960), 1, torch.float32, False),
    ("bf16_B1_19x19_C960_s2", (1, 19, 19, 960), 2, torch.bfloat16, False),
    ("bf16_33x70_C24_s1", (2, 33, 70, 24), 1, torch.bfloat16, True),
    ("f32_17x130_C8_s2", (2, 17, 130, 8), 2, torch.float32, False),
]


def _dw_sum_line(r: dict) -> dict:
    """A sum over layers; the share net of the timing floor counts each
    layer's kernel time less the time an empty kernel takes."""
    return dict(kernel_ms=r["ms"], call_ms=r["call_ms"],
                bound_ms=r["bound_ms"], plain_ms=r["plain_ms"],
                library_ms=r["library_ms"],
                share_of_bound=r["bound_ms"] / r["ms"],
                library_over_kernel=r["library_ms"] / r["ms"],
                layers=r["layers"], timing_floor_ms=r["floor_ms"],
                share_of_bound_net_of_floor=r["bound_ms"] / max(
                    r["ms"] - r["layers"] * r["floor_ms"], 1e-9))


def _dw_back_to_back(dev, order: list, gen, res: dict) -> float:
    """The eval step's depthwise layers in the step's order, each bound
    outside the timed span, launched back to back in one CUDA-event window
    with no L2 flush between them (as a step runs them; the window is
    timed 20 times after 3 warm-ups, the L2 flushed before each window).
    Against the per-layer sum, this shows how much of the per-layer timing
    floor a step actually pays."""
    bound = {}
    for shape, stride in dict.fromkeys(order):
        x, taps, _, _ = _dw_inputs(shape, torch.bfloat16, gen, dev)
        # (launch, out): the launch closure holds x and the taps, the pair
        # keeps its output alive
        bound[(shape, stride)] = dwk.bind(x, taps, None, None, stride, False)
    launches = [bound[key][0] for key in order]

    def window():
        for launch in launches:
            launch()

    ms = event_ms(window, flush=l2_flush_buffer(dev))
    emit("kernel_dw", case="back_to_back", layers=len(launches),
         kernel_ms=ms, bound_ms=res["bound_ms"],
         share_of_bound=res["bound_ms"] / ms, sum_all_kernel_ms=res["ms"],
         sum_all_share_of_bound=res["bound_ms"] / res["ms"],
         timing="CUDA events around all the layers of one eval step in the "
                "step's order, mean of 20 after 3 warm-up, L2 flushed "
                "before each window, not between layers")
    del bound, launches
    return ms


def kernel_dw_phase(dev, order: list) -> dict:
    """The depthwise kernel against reference_impl at every distinct
    (input shape, stride) of one serve_dw batch (bf16, identity affine, no
    clip, taps as _DepthwiseConv passes them), timed as the kernel alone
    (the C entry with its arguments bound outside the timed span), as the
    whole ``depthwise_conv3x3`` call, as the plain version and as cuDNN;
    then the extra cases, the flipped-tap input gradient, a determinism
    check, and the profiler's count of kernels in one forward and one
    stride-1 input-gradient call. The kernel rounds once where its plain
    version does, with no FMA contraction: bit-equal is expected, 1 bf16
    ulp (float32: 1e-6 relative) is the tolerance. Sums weight each layer
    by its count in one eval step, over all layers and by stride."""
    gen = torch.Generator(device=dev).manual_seed(20)
    flush = l2_flush_buffer(dev)
    # the timing floor: an empty kernel timed as the kernels are
    floor = event_ms(lambda: torch.cuda._sleep(0), flush=flush)
    emit("kernel_dw", case="timing_floor", ms=floor,
         what="torch.cuda._sleep(0), timed as the kernels are")
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "library_ms",
            "bytes_s", "ops_s", "layers")
    res = {"max_abs_err": 0.0, **{k: 0.0 for k in keys},
           "s1": {k: 0.0 for k in keys}, "s2": {k: 0.0 for k in keys}}
    for r in (res, res["s1"], res["s2"]):
        r["floor_ms"] = floor
    layers = Counter(order)
    for (shape, stride), count in sorted(layers.items()):
        x, taps, _, _ = _dw_inputs(shape, torch.bfloat16, gen, dev)
        with torch.no_grad():
            got = dwk.depthwise_conv3x3(x, taps, stride=stride)
            want = dwk.reference_impl(x, taps, None, None, stride, False)
            lib = _cudnn_dw(x, taps, stride)
            lib_err = float((lib().permute(0, 2, 3, 1).float()
                             - want.float()).abs().max())
            torch.cuda.synchronize()
            err = _dw_check(f"{shape} s{stride}", got, want, torch.bfloat16)
            nbytes, ops = dw_work(shape, stride, 2, taps.element_size())
            bound, bound_by = bound_ms(nbytes, ops)
            launch, _ = dwk.bind(x, taps, None, None, stride, False)
            k_ms = event_ms(launch, flush=flush)
            c_ms = event_ms(lambda: dwk.depthwise_conv3x3(x, taps,
                                                          stride=stride),
                            flush=flush)
            p_ms = event_ms(lambda: dwk.reference_impl(
                x, taps, None, None, stride, False), iters=5, warmup=1,
                flush=flush)
            l_ms = event_ms(lib, flush=flush)
            host_ms = host_call_ms(lambda: dwk.depthwise_conv3x3(
                x, taps, stride=stride))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        for key, v in (("ms", k_ms), ("call_ms", c_ms), ("plain_ms", p_ms),
                       ("bound_ms", bound), ("library_ms", l_ms),
                       ("bytes_s", nbytes / HBM_BYTES_PER_S),
                       ("ops_s", ops / F32_OPS_PER_S), ("layers", 1)):
            res[key] += count * v
            res[f"s{stride}"][key] += count * v
        plan = dwk.tile_plan(*shape, stride, 2)
        emit("kernel_dw", case="flagship", shape=list(shape), stride=stride,
             dtype="bfloat16", calls_per_eval_step=count, max_abs_err=err,
             tolerance="1 bf16 ulp", kernel_ms=k_ms, call_ms=c_ms,
             plain_ms=p_ms, bound_ms=bound, bound_by=bound_by, bytes=nbytes,
             ops=ops, achieved_GBps=nbytes / k_ms / 1e6,
             share_of_bound=bound / k_ms, library_ms=l_ms,
             library="F.conv2d(groups=C) on the channels_last view" + (
                 "" if stride == 1 else ", after F.pad (two calls)"),
             library_vs_plain_max_abs_diff=lib_err, wrapper_host_ms=host_ms,
             tile=dict(th=plan.th, tw=plan.tw, cb=plan.cb, vec=plan.vec,
                       threads=plan.threads, smem_bytes=plan.smem_bytes,
                       tiles=plan.tiles),
             timing="CUDA events, kernel, call and library mean of 20 "
                    "after 3 warm-up, plain mean of 5 after 1, L2 flushed "
                    "between launches")
        del x, got, want, lib, launch
    check(res["layers"] == DW_STEP["eval"][0],
          f"{res['layers']} depthwise layers in one eval step, expected "
          f"{DW_STEP['eval'][0]}")
    for case, r in (("sum_stride1", res["s1"]), ("sum_stride2", res["s2"]),
                    ("sum_all", res)):
        emit("kernel_dw", case=case, **_dw_sum_line(r))
    res["back_to_back_ms"] = _dw_back_to_back(dev, order, gen, res)

    for label, shape, stride, dtype, affine in DW_EXTRA_CASES:
        x, taps, scale, bias = _dw_inputs(shape, dtype, gen, dev, affine)
        got = dwk.depthwise_conv3x3(x, taps, stride=stride, scale=scale,
                                    bias=bias, relu6=affine)
        want = dwk.reference_impl(x, taps, scale, bias, stride, affine)
        torch.cuda.synchronize()
        err = _dw_check(label, got, want, dtype)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        emit("kernel_dw", case=label, shape=list(shape), stride=stride,
             dtype=str(dtype).replace("torch.", ""), affine_relu6=affine,
             max_abs_err=err, tolerance="1 bf16 ulp" if dtype ==
             torch.bfloat16 else "1e-6 relative")

    # the stride-1 input gradient at the largest stride-1 flagship layer:
    # autograd launches the kernel with flipped taps, on the masked and
    # scaled cotangent (affine, ReLU6) and on the cotangent as it comes (as
    # the model calls it); the same calls through the plain version must
    # agree
    shape = max((s for s, st in layers if st == 1), key=math.prod)
    for affine in (True, False):
        x, taps, scale, bias = _dw_inputs(shape, torch.bfloat16, gen, dev,
                                          affine)
        x.requires_grad_(True)
        out = dwk.depthwise_conv3x3(x, taps, stride=1, scale=scale,
                                    bias=bias, relu6=affine)
        ct = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
        before = dict(dwk.launch_counts)
        out.backward(ct)
        torch.cuda.synchronize()
        check(dwk.launch_counts[dwk.KERNEL_DX] == before[dwk.KERNEL_DX] + 1,
              "the stride-1 input gradient did not launch the kernel")
        with torch.no_grad():
            gc = ct
            if affine:
                outf = out.float()
                gc = (ct.float() * ((outf > 0) & (outf < 6)).float()
                      * scale).to(x.dtype)
            want = dwk.reference_impl(gc, taps.flip(0, 1), None, None, 1,
                                      False)
        label = "flipped_tap_dx" + ("_affine_relu6" if affine else "")
        err = _dw_check(label, x.grad, want, torch.bfloat16)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        emit("kernel_dw", case=label, shape=list(shape), stride=1,
             dtype="bfloat16", max_abs_err=err, tolerance="1 bf16 ulp")
        del out, gc, want

    # determinism: two calls, the same bytes
    x, taps, _, _ = _dw_inputs(shape, torch.bfloat16, gen, dev)
    with torch.no_grad():
        first = dwk.depthwise_conv3x3(x, taps)
        second = dwk.depthwise_conv3x3(x, taps)
    check(torch.equal(first.view(torch.int16), second.view(torch.int16)),
          "two calls on the same inputs differ in their bytes")
    emit("kernel_dw", case="deterministic", shape=list(shape),
         identical_bytes=True)
    del x, first, second
    torch.cuda.empty_cache()
    return res


def one_kernel_phase(dev) -> None:
    """One depthwise forward call as _DepthwiseConv makes it, and one
    stride-1 input-gradient call on a contiguous cotangent (the taps need
    no gradient, so no cuDNN filter gradient runs), each put exactly one
    kernel on the card (torch.profiler). Run before any other profiler
    session of the process."""
    gen = torch.Generator(device=dev).manual_seed(21)
    x, taps, _, _ = _dw_inputs((40, 128, 128, 32), torch.bfloat16, gen, dev)
    with torch.no_grad():
        dwk.depthwise_conv3x3(x, taps)
    fwd = _device_kernels(lambda: dwk.depthwise_conv3x3(x, taps))
    xg = x.detach().requires_grad_(True)
    out = dwk.depthwise_conv3x3(xg, taps)
    ct = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
    torch.autograd.grad(out, xg, ct, retain_graph=True)
    dx = _device_kernels(lambda: torch.autograd.grad(out, xg, ct,
                                                     retain_graph=True))
    check(len(fwd) == 1 and len(dx) == 1 and "dw3x3" in fwd[0]
          and "dw3x3" in dx[0],
          f"one depthwise call put {fwd} (forward) and {dx} (input "
          "gradient) on the card, expected one kernel each")
    emit("one_kernel_a_call", shape=list(x.shape), forward_kernels=fwd,
         input_gradient_kernels=dx)
    del x, xg, out, ct
    # the epilogue's backward at the stage-3 train shape: its launch puts
    # the plan's kernels on the card (the memset of its tickets is no
    # kernel); the whole call adds the plain per-group sum of its rows
    args = _bwd_case_inputs("one", 40, 2, 14, 14, 1024, 1, 5,
                            torch.bfloat16, gen, dev)
    tp.fused_bn_add_relu_tpool_bwd(*args)
    bwd = _device_kernels(lambda: tp._launch_bwd_rows(*args))
    call = _device_kernels(lambda: tp.fused_bn_add_relu_tpool_bwd(*args))
    want = tp.bwd_plan(40, 2, 14, 14, 1024, 2,
                       torch.cuda.get_device_properties(
                           dev).multi_processor_count)["kernels"]
    check(len(bwd) == want and all(BWD_NAME in k for k in bwd),
          f"one backward launch put {bwd} on the card, expected {want} "
          f"kernel(s) named {BWD_NAME}")
    check(sum(BWD_NAME in k for k in call) == want,
          f"one backward call put {call} on the card, expected {want} "
          f"kernel(s) named {BWD_NAME} beside the per-group sum")
    emit("one_kernel_a_call", shape=[40, 2, 14, 14, 1024],
         backward_kernels=bwd, planned=want, backward_call_kernels=call)
    del args
    torch.cuda.empty_cache()


# (N, F, H, W, C, dtype): the prototype against its plain version, beside
# the tools' three stage shapes: float32, odd frame counts, one frame
PROTO_CASES = [
    (8, 8, 14, 14, 64, torch.bfloat16), (8, 8, 14, 14, 64, torch.float32),
    (10, 3, 9, 9, 32, torch.bfloat16), (6, 5, 12, 12, 48, torch.float32),
    (4, 1, 8, 8, 16, torch.bfloat16),
]


def tools_phase(dev) -> dict:
    """The prototype kernel against its plain version (it rounds z and the
    residual add where the plain version does: bit-equal expected, 1 bf16
    ulp or 1e-6 relative the tolerance), then the path of the kernel tools:
    counts zeroed, both tools run at their shapes, counts read."""
    gen = torch.Generator(device=dev).manual_seed(30)
    err_max = 0.0
    for n, f, h, w, c, dtype in PROTO_CASES:
        y = torch.randn((n, f, h, w, c), generator=gen, device=dev).to(dtype)
        ident = torch.randn((n, f, h, w, c), generator=gen,
                            device=dev).to(dtype)
        a = 1.0 + 0.3 * torch.randn(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        got = tpp.tpool_proto(y, ident, a, b)
        want = tpp.reference_impl(y, ident, a, b)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if dtype == torch.bfloat16:
            ok, tol = within_one_bf16_ulp(got, want), "1 bf16 ulp"
        else:
            ok = bool(((got - want).abs() <= 1e-6 * want.abs()).all())
            tol = "1e-6 relative"
        check(ok, f"tpool_proto {(n, f, h, w, c)} {dtype}: beyond {tol} of "
                  f"its plain version (max abs err {err})")
        err_max = max(err_max, err)
        emit("tools", case="tpool_proto_vs_plain", shape=[n, f, h, w, c],
             dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
             tolerance=tol)

    # the tools' path: counts zeroed just before, read just after
    zero_counts()
    dw_rows = bench_depthwise.run(dev)
    tp_rows = bench_tpool.run(dev)
    bwd_rows = bench_tpool_bwd.run(dev)
    launches = all_counts()
    for row in dw_rows:
        emit("tools", tool="bench_depthwise", **row)
    for row in bwd_rows:
        emit("tools", tool="bench_tpool_bwd", **row)
        check(row["row"] == "add" or (row["dy_dident_equal"]
                                      and row["rows_within_1e4"]),
              f"bench_tpool_bwd {row['stage']} {row['row']}: dy/dident or "
              "the rows' sums differ from the planned launch's")
    res = {"proto_max_abs_err": err_max, "launches": launches, "ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "bytes_s": 0.0, "ops_s": 0.0}
    for row in tp_rows:
        emit("tools", tool="bench_tpool", **row)
        if row["row"] == "kernel":
            check(row["within_1ulp_of_plain"], f"bench_tpool {row['stage']}: "
                  "the prototype kernel beyond 1 bf16 ulp of its plain "
                  "version")
            nbytes, ops = tpool_work(*row["shape"], 2)
            res["ms"] += row["ms"]
            res["bound_ms"] += bound_ms(nbytes, ops)[0]
            res["bytes_s"] += nbytes / HBM_BYTES_PER_S
            res["ops_s"] += ops / F32_OPS_PER_S
        if row["row"] == "tpool_slice":
            res["plain_ms"] += row["ms"]
    check(launches[tpp.KERNEL] > 0 and launches[dwk.KERNEL] > 0
          and launches[tp.KERNEL_BWD] > 0,
          f"the tools launched no kernel: {launches}")
    res["dw_rows"] = dw_rows
    torch.cuda.empty_cache()
    return res


# mem_analysis at batch 8: (phase, --fused_tpool) -> the epilogue's
# (forward, backward) launches in the measured step
MEM_LAUNCHES = {("policy", 1): (3, 0), ("main", 1): (3, 3),
                ("policy", 0): (0, 0), ("main", 0): (0, 0)}


def update_mem_phase(dev, card: str, train_peak: int) -> dict:
    """The update and memory tools at flagship width. (a) bench_update's
    rows (SGD over the main net, Adam over the policy net; per_tensor,
    foreach and vector), each with its bound and share, and the rows'
    agreement: bit for bit, or within 1e-6 of each tensor's largest value.
    (b) mem_analysis at batch 8 in both phases with --fused_tpool 1 and 0:
    the epilogue's launches in the measured step (MEM_LAUNCHES), a peak
    above the arguments, and the main phase's fused peak within 5% of
    ``train_peak``: the peak train_phase read around the same step, less
    what that phase held besides one step's batch. (c) mem_analysis at the JAX
    tool's default, batch 24 in the policy phase. Counts zeroed before (b)
    and read after (c)."""
    t0 = time.perf_counter()
    for row in bench_update.run(dev):
        for label, entries in row.get("agreement", {}).items():
            for k, a in entries.items():
                check(a["bitwise"] or a["max_rel_diff"] <= 1e-6,
                      f"bench_update {row['optimizer']}: the {label} row's "
                      f"{k} beyond 1e-6 of the foreach row's ({a})")
        emit("update_mem", tool="bench_update", card=card, **row)
    zero_counts()
    runs = {}
    for phase in ("policy", "main"):
        for fused in (1, 0):
            runs[phase, fused] = mem_analysis.run(dev, phase=phase, batch=8,
                                                  fused_tpool=fused)
    runs["policy", 1, 24] = mem_analysis.run(dev, phase="policy", batch=24,
                                             fused_tpool=1)
    launches = all_counts()
    for key, r in runs.items():
        got = (r["launches"][tp.KERNEL], r["launches"][tp.KERNEL_BWD])
        check(got == MEM_LAUNCHES[key[:2]],
              f"mem_analysis {key}: {got} epilogue (forward, backward) "
              f"launches, expected {MEM_LAUNCHES[key[:2]]}")
        check(r["peak_bytes"] > r["arguments_bytes"],
              f"mem_analysis {key}: peak {r['peak_bytes']} not above the "
              f"arguments {r['arguments_bytes']}")
        emit("update_mem", tool="mem_analysis", card=card, **r)
    peak = runs["main", 1]["peak_bytes"]
    check(abs(peak - train_peak) <= 0.05 * train_peak,
          f"mem_analysis main-phase peak {peak} not within 5% of "
          f"train_phase's {train_peak} (its peak less what it held "
          f"besides one step's batch)")
    emit("update_mem", case="main_peak_vs_train", mem_analysis=peak,
         train=train_peak, ratio=peak / train_peak,
         fused_off_minus_on={p: runs[p, 0]["peak_bytes"]
                             - runs[p, 1]["peak_bytes"]
                             for p in ("policy", "main")},
         launches=launches, seconds=time.perf_counter() - t0)
    return {"launches": launches}


# the flagship's flags (flagship_cfg(): ResNet-50, 224, default canvas and
# audio) with a synthetic epoch of 16 videos, 8 clips a batch. A model_best
# is written only when a validation's top-1 beats 0, which a random model
# on 16 videos and 31 classes often misses: on the H100 seeds 0-5 scored 0
# at the alternating epoch and seed 7 scored 6.25, so seed 7 drives the
# model_best reload (the checks accept either outcome, consistently)
FLAGSHIP_FLAGS = (
    "--modality rgb sound --groups 8 --frames_per_group 4 "
    "--num_segments 5 --dense_sampling --causality_modeling lstm "
    "--learnable_lf_weights --cost_weights 1.0 0.05 --sync-bn "
    "--val_num_clips 5 -b 8 --warmup_epochs 1 --epochs 1 "
    "--finetune_epochs 1 -j 8 --seed 7").split()
CLI_ADAMML = ["--dataset", "synthetic", "--synthetic_length", "16",
              *FLAGSHIP_FLAGS]
# the curriculum with K = 2 steps a dispatch, packed eval at capacity 0.5
# and step traces: 48 videos, 6 batches a pass, so each pass runs one
# dispatch of K single steps, one capture with its first replay (traced, loader
# indices 2-4) and one more replay
CLI_MULTI = ["--dataset", "synthetic", "--synthetic_length", "48",
             *FLAGSHIP_FLAGS, "--steps_per_dispatch", str(K_DISPATCH),
             "--eval_capacity", "0.5"]
CLI_UNIMODAL = (
    "--dataset synthetic --modality rgb --backbone_net resnet -d 50 "
    "--groups 8 -b 8 --epochs 1 --synthetic_length 16 -j 8").split()
BANNERS = ("Stage [Warming up]", "Stage [Alternative training]: 1 epochs",
           "Stage [Alternative training]: Training Main net",
           "Stage [Alternative training]: Training Policy net",
           "Stage [Post finetuning]")


class _CliProbe:
    """Wraps the curriculum's train_epoch and validate and the log's lines
    while a CLI runs: each epoch's launches (forward and backward epilogue
    kernels, depthwise kernel), summary and seconds, and the time of every
    log line. Measurement only; the CLI runs as a user calls it."""

    def __init__(self):
        self.epochs, self.lines = [], []

    def __enter__(self):
        self._saved = (cur.train_epoch, cur.validate, RankZeroLogger.log)
        train_epoch, validate, log = self._saved

        def wrap(kind, fn):
            def run(*args, **kwargs):
                before = all_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                after = all_counts()
                summary = out[1] if kind == "train" else out
                self.epochs.append(dict(
                    kind=kind, seconds=time.perf_counter() - t0,
                    cost=list(kwargs.get("cost_weights") or []),
                    summary=summary,
                    launches={k: after[k] - before[k] for k in after}))
                return out
            return run

        def log_line(logger, msg, **kwargs):
            self.lines.append((time.perf_counter(), msg))
            return log(logger, msg, **kwargs)

        cur.train_epoch = wrap("train", train_epoch)
        cur.validate = wrap("val", validate)
        RankZeroLogger.log = log_line
        return self

    def __exit__(self, *exc):
        cur.train_epoch, cur.validate, RankZeroLogger.log = self._saved


def _run_cli(main_fn, argv, logdir):
    """One CLI run on the card: counts zeroed just before, read just after;
    peak memory; the probe's epochs and log lines; wall seconds."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for k in loaders.decode_counts:
        loaders.decode_counts[k] = 0
    t0 = time.perf_counter()
    with _CliProbe() as probe:
        rc = main_fn(argv + ["--logdir", logdir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(rc == 0, f"{argv[:4]}...: exit code {rc}")
    return dict(launches=all_counts(), seconds=seconds, t0=t0,
                end=time.perf_counter(), probe=probe,
                peak=torch.cuda.max_memory_allocated(),
                decoded=dict(loaders.decode_counts))


def _check_epochs(label, epochs, batch=8, per_pass=3):
    """Per epoch: finite losses, selection rates in [0, 100] %, and the
    epilogue launches: ``per_pass`` (the ResNet's 3 stage boundaries; 0
    without a ResNet) forward a forward pass (a train step or a val batch
    of ``batch`` clips), as many backward a main-phase step, 0 in a policy
    epoch."""
    for i, e in enumerate(epochs):
        s, n = e["summary"], None
        check(math.isfinite(s["loss"]), f"{label} epoch {i}: loss {s['loss']}")
        sel = s["selection"].values()
        check(all(0.0 <= 100 * v <= 100.0 for v in sel),
              f"{label} epoch {i}: selection {s['selection']}")
        if e["kind"] == "train":
            n = s["num_batch"]
            policy = any(e["cost"])
            want = (per_pass * n, 0 if policy else per_pass * n)
        else:
            n = -(-len(s["outputs"]) // batch)
            want = (per_pass * n, 0)
        got = (e["launches"][tp.KERNEL], e["launches"][tp.KERNEL_BWD])
        check(got == want, f"{label} {e['kind']} epoch {i} ({n} batches): "
              f"{got} (forward, backward) epilogue launches, expected {want}")


def _stage_seconds(run, banners) -> dict:
    """Wall seconds from each stage banner to the next (the last to the
    run's end)."""
    marks = [(t, msg) for t, msg in run["probe"].lines
             if any(msg.startswith(b) for b in banners)
             and "Training" not in msg]
    out = {}
    for (t, msg), nxt in zip(marks, marks[1:] + [(run["end"], None)]):
        out[msg.split(":")[0] if "]:" in msg else msg] = nxt[0] - t
    out["setup_before_first_stage"] = (marks[0][0] - run["t0"] if marks
                                       else None)
    return out


def _epoch_line(e) -> dict:
    s = e["summary"]
    line = dict(kind=e["kind"], seconds=e["seconds"],
                loss=s["loss"], top1=s["top1"],
                selection_percent={k: 100 * v
                                   for k, v in s["selection"].items()},
                batch_ms=s["batch_time"] * 1e3)
    if e["kind"] == "train":
        line.update(phase="policy" if any(e["cost"]) else "main",
                    batches=s["num_batch"],
                    dispatch_ms_per_batch=s["batch_time"] * 1e3,
                    drained_ms_per_batch=s["wall_time"] * 1e3,
                    data_ms_per_batch=s["data_time"] * 1e3,
                    data_share_of_drained=s["data_time"] / s["wall_time"])
    return line


def cli_phase(dev, card: str) -> dict:
    """Both training CLIs in process on the card, as a user runs them:
    train_adamml at the flagship's full width through the 3-stage
    curriculum, then its -e evaluation, then train_unimodal (rgb ResNet-50,
    224, 8 frames). Checks banners, artifacts, losses, selection rates and
    the epilogue kernels' launches of every epoch; prints one JSON line per
    run with the stages' wall seconds, the engine's ms/batch, data ms/batch
    and peak memory."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        run = _run_cli(train_adamml.main, CLI_ADAMML, tmp)
        lines = [msg for _, msg in run["probe"].lines]
        seen = [b for b in BANNERS if any(m.startswith(b) for m in lines)]
        check(seen == list(BANNERS), f"stage banners {seen}")
        folder = os.path.join(tmp, os.listdir(tmp)[0])
        files = set(os.listdir(folder))
        alt_top1 = run["probe"].epochs[3]["summary"]["top1"]
        # a model_best exists when the alternating epoch's val top-1 beat
        # the initial best of 0 (random weights may score 0 on 16 videos)
        best = alt_top1 > 0
        want = {"checkpoint", "checkpoint_warmup_01", "checkpoint_main_01",
                "checkpoint_finetune_01", "all_selection_main_1.npz",
                "all_selection_finetune_1.npz", "log.log"} | (
                    {"model_best"} if best else set())
        check(want <= files, f"artifacts {sorted(files)}, missing "
                             f"{sorted(want - files)}")
        check(any(m.startswith("Loaded model_best") for m in lines) == best,
              f"model_best reload (alternating top-1 {alt_top1}) not as "
              f"expected: {[m for m in lines if 'best' in m]}")
        kinds = [(e["kind"], bool(any(e["cost"])))
                 for e in run["probe"].epochs]
        check(kinds == [("train", False), ("train", False), ("train", True),
                        ("val", False), ("train", False), ("val", False)],
              f"epochs {kinds}")
        _check_epochs("train_adamml", run["probe"].epochs)
        out["train_adamml"] = run["launches"]
        emit("cli", run="train_adamml", card=card, argv=CLI_ADAMML,
             seconds=run["seconds"], stage_seconds=_stage_seconds(
                 run, BANNERS), epochs=[_epoch_line(e)
                                        for e in run["probe"].epochs],
             launches=run["launches"], max_memory_allocated_bytes=run["peak"],
             model_best=best, artifacts=sorted(files),
             timing="host clock; each epoch and validation ends in "
                    "torch.cuda.synchronize()")

        ev = _run_cli(train_adamml.main, CLI_ADAMML + ["-e"], tmp)
        files = set(os.listdir(folder))
        d = config_from_args(arg_parser().parse_args(CLI_ADAMML)).data
        npy = (f"val_{d.num_crops}crops_{d.val_num_clips}clips_"
               f"{d.input_size}_details_.npy")
        check({"all_selection.npz", npy} <= files, f"-e wrote {sorted(files)}")
        outputs = np.load(os.path.join(folder, npy))
        sel = np.load(os.path.join(folder, "all_selection.npz"))
        check(outputs.shape == (d.synthetic_length, 31)
              and np.isfinite(outputs).all(), f"-e outputs {outputs.shape}")
        check(sel["selections"].shape == (d.synthetic_length,
                                          d.val_num_clips, 2),
              f"-e selections {sel['selections'].shape}")
        _check_epochs("train_adamml -e", ev["probe"].epochs)
        out["train_adamml_evaluate"] = ev["launches"]
        emit("cli", run="train_adamml -e", card=card, seconds=ev["seconds"],
             epochs=[_epoch_line(e) for e in ev["probe"].epochs],
             launches=ev["launches"], max_memory_allocated_bytes=ev["peak"],
             outputs_shape=list(outputs.shape))

    with tempfile.TemporaryDirectory() as tmp:
        run = _run_cli(train_unimodal.main, CLI_UNIMODAL, tmp)
        folder = os.path.join(tmp, os.listdir(tmp)[0])
        files = set(os.listdir(folder))
        check({"checkpoint", "checkpoint_01", "log.log"} <= files,
              f"train_unimodal artifacts {sorted(files)}")
        kinds = [e["kind"] for e in run["probe"].epochs]
        check(kinds == ["train", "val"], f"train_unimodal epochs {kinds}")
        _check_epochs("train_unimodal", run["probe"].epochs)
        out["train_unimodal"] = run["launches"]
        emit("cli", run="train_unimodal", card=card, argv=CLI_UNIMODAL,
             seconds=run["seconds"],
             epochs=[_epoch_line(e) for e in run["probe"].epochs],
             launches=run["launches"], max_memory_allocated_bytes=run["peak"],
             artifacts=sorted(files))
    out.update(_cli_multi_run(card))
    out["show_model"] = _cli_show_model(card)
    torch.cuda.empty_cache()
    return out


def _trace_kernel_counts(path: str) -> dict:
    """The epilogue and depthwise kernels in a StepProfiler trace."""
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return {"forward": sum(FWD_NAME in n and BWD_NAME not in n
                           for n in names),
            "backward": sum(BWD_NAME in n for n in names),
            "depthwise": sum(DW_NAME in n for n in names),
            "kernels": len(names)}


def _cli_multi_run(card: str) -> dict:
    """train_adamml with --steps_per_dispatch 2 --eval_capacity 0.5
    --profile_dir: each training pass's first epoch writes a trace of
    whole dispatches from loader index 2K on, after the one that captures
    the graph: on 6 batches a pass, one replay of K steps (its kernels
    counted from the trace); the wrappers count the first
    dispatch's launches (K single steps) and the capture's, none of the replays."""
    k = K_DISPATCH
    with tempfile.TemporaryDirectory() as tmp:
        traces = os.path.join(tmp, "traces")
        argv = CLI_MULTI + ["--profile_dir", traces]
        run = _run_cli(train_adamml.main, argv, os.path.join(tmp, "logs"))
        lines = [msg for _, msg in run["probe"].lines]
        seen = [b for b in BANNERS if any(m.startswith(b) for m in lines)]
        check(seen == list(BANNERS), f"multi-step run: banners {seen}")
        epochs = run["probe"].epochs
        kinds = [(e["kind"], bool(any(e["cost"]))) for e in epochs]
        check(kinds == [("train", False), ("train", False), ("train", True),
                        ("val", False), ("train", False), ("val", False)],
              f"multi-step run: epochs {kinds}")
        for i, e in enumerate(epochs):
            sm = e["summary"]
            check(math.isfinite(sm["loss"]), f"multi-step epoch {i}: loss")
            got = (e["launches"][tp.KERNEL], e["launches"][tp.KERNEL_BWD])
            if e["kind"] == "train":
                check(sm["num_batch"] == 6, f"epoch {i}: "
                      f"{sm['num_batch']} batches")
                # 2K steps launched by the host: the first dispatch's and
                # the capture's; the replays launch from the graph
                policy = any(e["cost"])
                want = (3 * 2 * k, 0 if policy else 3 * 2 * k)
            else:
                want = (3 * -(-len(sm["outputs"]) // 8), 0)
            check(got == want, f"multi-step {e['kind']} epoch {i}: {got} "
                  f"(forward, backward) host-counted launches, expected "
                  f"{want}")
        files = sorted(glob.glob(os.path.join(traces, "*.pt.trace.json")))
        check(len(files) == 4, f"--profile_dir wrote {len(files)} traces, "
              f"expected 4 (warmup, main, policy, finetune)")
        in_trace = [_trace_kernel_counts(f) for f in files]
        for i, (cnt, policy) in enumerate(zip(in_trace, (False, False, True,
                                                         False))):
            want = (3 * k, 0 if policy else 3 * k)
            check((cnt["forward"], cnt["backward"]) == want,
                  f"trace {i}: {cnt} epilogue kernels, expected {want} "
                  f"(one replay of {k} steps)")
        emit("cli", run="train_adamml --steps_per_dispatch 2 "
                        "--eval_capacity 0.5 --profile_dir", card=card,
             argv=argv, seconds=run["seconds"],
             stage_seconds=_stage_seconds(run, BANNERS),
             epochs=[_epoch_line(e) for e in epochs],
             capacity_dropped=[e["summary"].get("capacity_dropped")
                               for e in epochs if e["kind"] == "val"],
             launches=run["launches"], trace_files=len(files),
             trace_kernels=in_trace,
             max_memory_allocated_bytes=run["peak"],
             timing="host clock; each epoch and validation ends in "
                    "torch.cuda.synchronize()")
    return {"train_adamml_multi": run["launches"],
            "train_adamml_multi_traces": in_trace}


def _cli_show_model(card: str) -> str:
    """train_adamml --show_model: the module, its parameters and the eval
    forward's FLOPs at batch 1 (FlopCounterMode)."""
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(buf):
        rc = train_adamml.main(CLI_ADAMML + ["--show_model", "--logdir",
                                             tmp])
    check(rc == 0, f"--show_model: exit code {rc}")
    lines = buf.getvalue().splitlines()
    flops = [ln for ln in lines if ln.startswith("Total flops")]
    params = [ln for ln in lines if ln.startswith("Total params")]
    check(len(flops) == 1 and "GFLOPs (fwd, batch 1)" in flops[0],
          f"--show_model printed {flops}")
    emit("cli", run="train_adamml --show_model", card=card,
         params=params[0], flops=flops[0])
    return flops[0]


def _preprocess_card_vs_cpu(dev, cfg, batch) -> dict:
    """One host batch through make_batch_preprocessor on the card and on
    the CPU, float32 out (TF32 off): each modality within 1e-3; plus the
    card's time for the batch."""
    got = {}
    for d in (dev, torch.device("cpu")):
        pre = make_batch_preprocessor(
            cfg, train=True, num_segments=cfg.model.num_segments, device=d)
        inputs, target = pre(batch)
        got[d.type] = [x.cpu() for x in inputs]
    pre = make_batch_preprocessor(
        cfg, train=True, num_segments=cfg.model.num_segments, device=dev)
    pre(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        pre(batch)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) / 5 * 1e3
    errs = {m: float((a - b).abs().max()) for m, a, b in
            zip(cfg.model.modality, got["cuda"], got["cpu"])}
    check(all(e <= 1e-3 for e in errs.values()),
          f"preprocessing card vs CPU: {errs} > 1e-3")
    return dict(max_abs_diff=errs, tolerance=1e-3,
                shapes={m: list(x.shape) for m, x in
                        zip(cfg.model.modality, got["cpu"])},
                card_ms_per_batch=card_ms,
                timing="host clock over 5 calls after 1 warm-up, ending in "
                       "torch.cuda.synchronize(): host batch to inputs on "
                       "the card, pinned copy included")


def preprocess_phase(dev) -> None:
    """One flagship synthetic training batch (8 clips, rgb 5 x 8 frames on
    the 256x464 canvas, sound 5 x 1.28 s) through make_batch_preprocessor
    on the card and on the CPU (float32, 1e-3)."""
    cfg = flagship_cfg()
    cfg.model.compute_dtype = "float32"
    cfg.data.dataset = "synthetic"
    cfg.data.synthetic_length = cfg.optim.batch_size = 8
    ds = cur._make_dataset(cfg, is_train=True,
                           num_clips=cfg.model.num_segments)
    batch = next(iter(cur._make_loader(cfg, ds, is_train=True)))
    emit("preprocess_card_vs_cpu", **_preprocess_card_vs_cpu(dev, cfg, batch))


# the real-data recipe (README.md): unimodal pretraining on the tree, the
# flagship curriculum from their checkpoints, then -e --pretrained
REAL_UNIMODAL = {
    "rgb": "--modality rgb --backbone_net resnet -d 50 --groups 8 -b 8 "
           "--epochs 1 -j 8".split(),
    "sound": "--modality sound -b 8 --epochs 1 -j 8".split()}


class _GraftProbe:
    """Keeps a CPU copy of the model right after each pretrained graft of
    the curriculum (and the temperature after --pretrained). Measurement
    only; the trainer calls the loaders as a user's run does."""

    def __init__(self):
        self.after = {}

    def __enter__(self):
        self._saved = (cur.load_unimodality_pretrained,
                       cur.load_pretrained_adamml)
        uni, whole = self._saved

        def snapshot(name, load):
            def run(model, *args, **kwargs):
                out = load(model, *args, **kwargs)
                self.after[name] = {k: v.detach().cpu().clone()
                                    for k, v in model.state_dict().items()}
                return out
            return run

        def whole_and_temperature(model, state, path):
            out = snapshot("pretrained", whole)(model, state, path)
            self.after["temperature"] = state.temperature
            return out

        cur.load_unimodality_pretrained = snapshot("unimodal", uni)
        cur.load_pretrained_adamml = whole_and_temperature
        return self

    def __exit__(self, *exc):
        cur.load_unimodality_pretrained, cur.load_pretrained_adamml = (
            self._saved)


def _expected_jpegs(argv, epochs, batch=8) -> int:
    """The rgb frames a run decodes: per fetched sample (padded eval rows
    included) groups x clips, clips = num_segments (train_adamml train),
    val_num_clips (its validation), num_clips (train_unimodal)."""
    cfg = config_from_args(arg_parser().parse_args(argv))
    if "rgb" not in cfg.model.modality:
        return 0
    adamml = len(cfg.model.modality) > 1
    total = 0
    for e in epochs:
        if e["kind"] == "train":
            clips = cfg.model.num_segments if adamml else cfg.data.num_clips
            total += e["summary"]["num_batch"] * batch * clips
        else:
            clips = cfg.data.val_num_clips if adamml else cfg.data.num_clips
            total += -(-len(e["summary"]["outputs"]) // batch) * batch * clips
    return total * cfg.model.groups


def _check_decoded(label, run, argv, decoder) -> dict:
    want = _expected_jpegs(argv, run["probe"].epochs)
    other = "pil" if decoder == "native" else "native"
    check(run["decoded"][decoder] == want and run["decoded"][other] == 0,
          f"{label}: decoded {run['decoded']}, expected {want} JPEGs, all "
          f"through {decoder}")
    return run["decoded"]


def _check_equal(label, got: dict, want: dict, prefix="") -> int:
    bad = [k for k, v in want.items() if not torch.equal(got[prefix + k], v)]
    check(not bad, f"{label}: {len(bad)} tensors differ, e.g. {bad[:3]}")
    return len(want)


def real_data_phase(dev, card: str) -> dict:
    """The paper's recipe on real files, as a user runs it, at full width
    (README.md): a generated kinetics-sounds tree (16 videos of 64 JPEG
    frames at 256x340, 24 kHz mono WAVs, one video without its WAV);
    train_unimodal rgb (ResNet-50, 8 frames) and sound (MobileNetV2), one
    epoch each; train_adamml with the flagship's flags through the 3-stage
    curriculum with --unimodality_pretrained set to their checkpoints;
    then train_adamml -e --pretrained with its model_best (its checkpoint
    when no validation beat top-1 0). Checks every epoch's epilogue
    launches, losses and selection rates, the grafts bit for bit, that
    every JPEG went through the reported decoder, one real batch's
    preprocessing on the card against the CPU, and both decoders against
    each other where both load."""
    decoder = "native" if native_available() else "pil"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tree = bench_pipeline.generate_tree(os.path.join(tmp, "tree"))
        rgb, sound = (os.path.join(tree["root"], m) for m in ("rgb",
                                                              "sound"))
        import PIL
        import scipy

        emit("real_data", run="tree", card=card, decoder=decoder,
             native_library="loads" if decoder == "native" else load_error(),
             host=dict(python=sys.version.split()[0], pil=PIL.__version__,
                       scipy=scipy.__version__, numpy=np.__version__,
                       cores=os.cpu_count()), **tree)

        # decode ms per frame on this host, each decoder that loads
        rows = bench_pipeline.decode_threads(tree["root"], videos=4)
        emit("real_data", run="decode", card=card, rows=rows,
             timing="host clock, 256 frames into the 256x464 canvas")
        ds = VideoDataset(rgb, "val.txt", num_groups=8, is_train=False,
                          separator=";")
        if decoder == "native":
            ds_pil = VideoDataset(rgb, "val.txt", num_groups=8,
                                  is_train=False, separator=";",
                                  use_native_decoder=False)
            idx = np.arange(1, tree["frames"] + 1)
            a = ds.get_data(ds.video_list[0], idx)["frames"].astype(int)
            b = ds_pil.get_data(ds.video_list[0], idx)["frames"].astype(int)
            diff = int(np.abs(a - b).max())
            check(diff <= 1, f"native vs PIL decode: {diff} LSB > 1")
            emit("real_data", run="native_vs_pil", max_abs_diff=diff,
                 tolerance=1)
        snd = VideoDataset(sound, "val.txt", modality="sound", num_groups=8,
                           is_train=False, separator=";")
        valid = [float(snd.get_sample(i)[0]["valid"].min())
                 for i in range(len(snd))]
        check(valid.count(0.0) == tree["videos"] - tree["wavs"],
              f"sound windows with valid=0: {valid}")

        # one real batch through the device preprocessing, card vs CPU
        cfg = config_from_args(arg_parser().parse_args(
            ["--dataset", "kinetics-sounds", "--datadir", rgb, sound,
             *FLAGSHIP_FLAGS]))
        cfg.model.compute_dtype = "float32"
        ds = cur._make_dataset(cfg, is_train=True,
                               num_clips=cfg.model.num_segments)
        batch = next(iter(cur._make_loader(cfg, ds, is_train=True)))
        emit("real_data", run="preprocess_card_vs_cpu",
             **_preprocess_card_vs_cpu(dev, cfg, batch))

        # unimodal pretraining
        ckpt = {}
        for m, flags in REAL_UNIMODAL.items():
            argv = ["--dataset", "kinetics-sounds", "--datadir",
                    os.path.join(tree["root"], m), *flags]
            logdir = os.path.join(tmp, f"uni_{m}")
            run = _run_cli(train_unimodal.main, argv, logdir)
            folder = os.path.join(logdir, os.listdir(logdir)[0])
            ckpt[m] = os.path.join(folder, "checkpoint")
            kinds = [e["kind"] for e in run["probe"].epochs]
            check(kinds == ["train", "val"], f"unimodal {m} epochs {kinds}")
            _check_epochs(f"train_unimodal {m}", run["probe"].epochs,
                          per_pass=3 if m == "rgb" else 0)
            label = f"train_unimodal_{m}"
            out[label] = run["launches"]
            emit("real_data", run=label, card=card, argv=argv,
                 seconds=run["seconds"],
                 epochs=[_epoch_line(e) for e in run["probe"].epochs],
                 launches=run["launches"],
                 decoded=_check_decoded(label, run, argv, decoder),
                 max_memory_allocated_bytes=run["peak"],
                 timing="host clock; each epoch and validation ends in "
                        "torch.cuda.synchronize()")

        # the curriculum from the unimodal checkpoints
        argv = ["--dataset", "kinetics-sounds", "--datadir", rgb, sound,
                *FLAGSHIP_FLAGS, "--unimodality_pretrained", ckpt["rgb"],
                ckpt["sound"]]
        logdir = os.path.join(tmp, "adamml")
        with _GraftProbe() as graft:
            run = _run_cli(train_adamml.main, argv, logdir)
        grafted = 0
        for m in ("rgb", "sound"):
            want = torch.load(os.path.join(ckpt[m], "state.pt"),
                              map_location="cpu", weights_only=True)["model"]
            grafted += _check_equal(f"graft of {m}", graft.after["unimodal"],
                                    want, prefix=f"main_net.net_{m}.")
        lines = [msg for _, msg in run["probe"].lines]
        seen = [b for b in BANNERS if any(x.startswith(b) for x in lines)]
        check(seen == list(BANNERS), f"stage banners {seen}")
        kinds = [(e["kind"], bool(any(e["cost"])))
                 for e in run["probe"].epochs]
        check(kinds == [("train", False), ("train", False), ("train", True),
                        ("val", False), ("train", False), ("val", False)],
              f"epochs {kinds}")
        _check_epochs("train_adamml (real)", run["probe"].epochs)
        folder = os.path.join(logdir, os.listdir(logdir)[0])
        best = os.path.join(folder, "model_best")
        source = best if os.path.isdir(best) else os.path.join(folder,
                                                               "checkpoint")
        out["train_adamml"] = run["launches"]
        emit("real_data", run="train_adamml", card=card, argv=argv,
             seconds=run["seconds"],
             stage_seconds=_stage_seconds(run, BANNERS),
             epochs=[_epoch_line(e) for e in run["probe"].epochs],
             launches=run["launches"],
             decoded=_check_decoded("train_adamml", run, argv, decoder),
             grafted_tensors=grafted, model_best=source == best,
             max_memory_allocated_bytes=run["peak"],
             timing="host clock; each epoch and validation ends in "
                    "torch.cuda.synchronize()")

        # -e --pretrained
        argv = ["--dataset", "kinetics-sounds", "--datadir", rgb, sound,
                *FLAGSHIP_FLAGS, "-e", "--pretrained", source]
        with _GraftProbe() as graft:
            ev = _run_cli(train_adamml.main, argv,
                          os.path.join(tmp, "evaluate"))
        payload = torch.load(os.path.join(source, "state.pt"),
                             map_location="cpu", weights_only=True)
        n = _check_equal("--pretrained", graft.after["pretrained"],
                         payload["model"])
        check(graft.after["temperature"] == payload["temperature"],
              f"--pretrained temperature {graft.after['temperature']} vs "
              f"{payload['temperature']}")
        _check_epochs("train_adamml -e --pretrained", ev["probe"].epochs)
        out["train_adamml_evaluate"] = ev["launches"]
        # --pred_files on what -e wrote: one file scores as its validation
        efolder = os.path.join(tmp, "evaluate",
                               os.listdir(os.path.join(tmp, "evaluate"))[0])
        npy = [os.path.join(efolder, f) for f in os.listdir(efolder)
               if f.startswith("val_") and f.endswith(".npy")]
        check(len(npy) == 1, f"-e wrote {npy}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_adamml.main(["--dataset", "kinetics-sounds",
                                    "--datadir", rgb, sound, *FLAGSHIP_FLAGS,
                                    "--pred_files", npy[0]])
        scored = buf.getvalue().strip().splitlines()[-1]
        top1 = ev["probe"].epochs[-1]["summary"]["top1"]
        check(rc == 0 and scored.startswith("Ensemble of 1 prediction")
              and f"Top@1: {top1:.4f}" in scored,
              f"--pred_files printed {scored!r}; -e scored top-1 {top1}")
        emit("real_data", run="--pred_files", card=card, line=scored,
             evaluate_top1=top1)
        emit("real_data", run="train_adamml -e --pretrained", card=card,
             source=os.path.basename(source), seconds=ev["seconds"],
             epochs=[_epoch_line(e) for e in ev["probe"].epochs],
             launches=ev["launches"],
             decoded=_check_decoded("-e --pretrained", ev, argv, decoder),
             grafted_tensors=n, temperature=payload["temperature"],
             max_memory_allocated_bytes=ev["peak"])
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# multi_process: data-parallel runs (adamml_tpu_torch/parallel/mesh.py)
# --------------------------------------------------------------------------

MP_TIMEOUT_S = 300
MP_STEPS = 3  # steps of each phase at world size 2
# the CLIs at world size 2: two processes sharing cuda:0 over gloo (NCCL
# refuses two ranks on one device); 13 videos are no multiple of 2 x 4, so
# the padded eval rows are masked
MP_UNIMODAL = ["--dataset", "synthetic", "--modality", "rgb",
               "--backbone_net", "resnet", "-d", "50", "--groups", "8",
               "-b", "8", "--epochs", "1", "--synthetic_length", "13",
               "-j", "4"]
MP_SPAWN = ["--dataset", "synthetic", "--modality", "rgb", "--backbone_net",
            "resnet", "-d", "18", "--groups", "4", "-b", "8", "--epochs",
            "1", "--synthetic_length", "13", "--input_size", "112", "-j", "4",
            "--multiprocessing-distributed"]


def _mp_digest(tensors) -> str:
    """sha256 of ``tensors``' bytes (parameters, buffers, metrics)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def _mp_state(model, metrics) -> list:
    return list(model.state_dict().values()) + [metrics[k]
                                                for k in sorted(metrics)]


def _mp_batches(cfg, batch, n, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(example_inputs(cfg, batch=batch, seed=seed + i, device=dev),
             torch.randint(0, cfg.model.num_classes, (batch,), generator=gen,
                           device=dev)) for i in range(n)]


def _mp_rows(batch, rank, world):
    """This rank's rows of a global batch: block ``rank`` of ``world``."""
    inputs, target = batch
    n = target.shape[0] // world
    return [x[rank * n:(rank + 1) * n] for x in inputs], \
        target[rank * n:(rank + 1) * n]


def _mp_full(model) -> dict:
    """The model's state with sharded weights gathered (a collective over
    the model group at --mesh_model > 1)."""
    from adamml_tpu_torch.parallel import mesh

    return {k: v.clone() for k, v in mesh.full_state_dict(model).items()}


def _mp_compare(mine, theirs, rtol, p_lr) -> list:
    """Per phase, a W-rank step against the single process from the same
    start: exact decisions and top-k, losses' relative difference, BN
    statistics and main-phase parameters beyond rtol (an absolute excess),
    the frozen subnet bit-equal, and the policy update's largest difference
    and share within 0.1 p_lr (tests/test_torch_multiprocess.py)."""
    out = []
    for (phase, start, got_m, got), (_, _, want_m, want) in zip(mine, theirs):
        live = phase + "_net."
        c = {"phase": phase,
             "exact": all(torch.equal(got_m[k], want_m[k])
                          for k in ("selection", "top1", "top5")),
             "loss_rel": max(float((got_m[k] - want_m[k]).abs()
                                   / want_m[k].abs().clamp_min(1e-12))
                             for k in ("loss", "cls_loss", "policy_loss")),
             "stats": 0.0, "params": 0.0, "policy_max": 0.0,
             "frozen_equal": True, "moved": 0, "close": 0, "total": 0}
        for k, v in want.items():
            d = (got[k] - v).abs()
            beyond = float((d - rtol * v.abs()).max())
            if k.endswith(("running_mean", "running_var")):
                c["stats"] = max(c["stats"], beyond)
            elif not v.is_floating_point() or not k.startswith(live):
                c["frozen_equal"] &= bool(torch.equal(got[k], v))
            else:
                c["moved"] += not torch.equal(start[0][k], got[k])
                if phase == "main":
                    c["params"] = max(c["params"], beyond)
                else:
                    c["policy_max"] = max(c["policy_max"], float(d.max()))
                    c["close"] += int((d <= 0.1 * p_lr).sum())
                    c["total"] += d.numel()
        out.append(c)
    return out


def _mp_tiny_run(cfg, batch, lr, p_lr, starts=None, bn_groups=None):
    """One main and one policy step of ``cfg`` on this rank's data shard
    of ``batch``; each phase from ``starts`` when given: (phase, start
    state, metrics, end state) per phase, sharded weights and their
    optimizer state gathered."""
    from adamml_tpu_torch.parallel import mesh

    model, _ = build_model(cfg, batch[1].device, bn_groups=bn_groups)
    state = _train_state(model, cfg)
    shards, index = mesh.data_world()
    inputs, target = _mp_rows(batch, index, shards)
    recs = []
    for i, phase in enumerate(("main", "policy")):
        if starts is not None:
            sd, opt_sd, state.step = starts[i]
            model.load_state_dict(sd)
            state.main_opt.load_state_dict(opt_sd[0])
            state.policy_opt.load_state_dict(opt_sd[1])
        start = (_mp_full(model),
                 [__import__("copy").deepcopy(mesh.full_optimizer_state(o))
                  for o in (state.main_opt, state.policy_opt)], state.step)
        m = _make_step(model, phase)(state, inputs, target, lr, p_lr,
                                     COST if phase == "policy" else [0., 0.],
                                     seed=3)
        recs.append((phase, start, {k: v.clone() for k, v in m.items()},
                     _mp_full(model)))
    return recs


def _mp_worker(argv) -> int:
    """One rank of the multi_process phase (chip_smoke.py --mp-worker task
    url rank world args): joins the gloo group on cuda:0, prints RESULT
    lines for the parent."""
    from adamml_tpu_torch.parallel import mesh

    task, url, rank, world, args = argv
    rank, world, args = int(rank), int(world), json.loads(args)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args["device"])

    def report(**fields):
        print("RESULT " + json.dumps({"rank": rank, **fields}), flush=True)

    if task == "cli":
        import adamml_tpu_torch.ckpt.checkpoint as ckpt

        real_write, real_validate = ckpt._write, cur.validate
        real_load = cur.load_checkpoint

        def write(*a):
            print(f"CKPT_WRITE {rank} {os.path.basename(a[3])}", flush=True)
            return real_write(*a)

        def validated(*a, **kw):
            v = real_validate(*a, **kw)
            print(f"VALROWS {rank} {len(v['outputs'])}", flush=True)
            return v

        def loaded(path, *a):
            print(f"LOADED {rank} {os.path.basename(path)}", flush=True)
            return real_load(path, *a)

        ckpt._write, cur.validate, cur.load_checkpoint = (write, validated,
                                                          loaded)
        main_fn = (train_adamml if args["cli"] == "train_adamml"
                   else train_unimodal).main
        return main_fn(args["argv"] + ["--dist-url", url, "--world-size",
                                       str(world), "--rank", str(rank),
                                       "--dist-backend", "gloo", "--gpu",
                                       "0"])

    if task in TP_TASKS:
        return TP_TASKS[task](url, rank, world, args, dev, report)
    cfg = flagship_cfg()
    _tp_join(cfg, url, rank, world, 1, dev)
    res = {}
    # the flagship at full width, bf16, 4 rows a rank of a global 8
    batches = _mp_batches(cfg, 8, MP_STEPS, 800, dev)
    for sync in (False, True):
        cfg.runtime.sync_bn = sync
        model, _ = build_model(cfg, dev)
        state = _train_state(model, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        digests, ms, trace = {}, {}, None
        for phase in ("main", "policy"):
            step = _make_step(model, phase)
            digests[phase], ms[phase] = [], []
            for i, b in enumerate(batches):
                inputs, target = _mp_rows(b, rank, world)
                if phase == "main" and i == len(batches) - 1:
                    held = {}
                    names = _device_kernels(lambda: held.update(m=step(
                        state, inputs, target, LR, P_LR, [0., 0.], seed=i)))
                    m = held["m"]
                    trace = {"forward": sum(FWD_NAME in n and BWD_NAME not in n
                                            for n in names),
                             "backward": sum(BWD_NAME in n for n in names),
                             "kernels": len(names)}
                else:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m = step(state, inputs, target, LR, P_LR,
                             COST if phase == "policy" else [0., 0.], seed=i)
                    torch.cuda.synchronize()
                    ms[phase].append((time.perf_counter() - t0) * 1e3)
                digests[phase].append(_mp_digest(_mp_state(model, m)))
        live = sum(p.numel() for p in model.main_net.parameters())
        flat = torch.zeros(live, device=dev)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.distributed.all_reduce(flat)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res["sync_bn" if sync else "per_replica_bn"] = dict(
            digests=digests, ms_per_step=ms, main_step_trace=trace,
            synced=all(getattr(b, "sync", False) for b in model.modules()
                       if hasattr(b, "running_mean")),
            allreduce_bytes=live * 4, allreduce_ms=times[1:],
            max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev))
        del model, state, step, flat
        torch.cuda.empty_cache()
    # the tiny float32 config, cuDNN deterministic, real Gumbel noise
    torch.backends.cudnn.deterministic = True
    tiny = flagship_cfg(tiny=True)
    tiny.runtime.world_size = world
    batch = _mp_batches(tiny, 8, 1, 900, dev)[0]
    mine = {}
    for sync in (False, True):
        tiny.runtime.sync_bn = sync
        mine[sync] = _mp_tiny_run(tiny, batch, LR, 1e-5)
    mesh.shutdown()
    if rank == 0:
        tiny.runtime.world_size = 1
        for sync in (False, True):
            tiny.runtime.sync_bn = sync
            theirs = _mp_tiny_run(
                tiny, batch, LR, 1e-5, bn_groups=1 if sync else world,
                starts=[(r[1][0], r[1][1], r[1][2]) for r in mine[sync]])
            res[f"tiny_{'sync' if sync else 'per_replica'}_bn_vs_single"] = \
                _mp_compare(mine[sync], theirs, 1e-4, 1e-5)
    res["tiny_digests"] = [
        _mp_digest(list(r[3].values()) + [r[2][k] for k in sorted(r[2])])
        for sync in (False, True) for r in mine[sync]]
    report(**res)
    return 0


# tensor_parallel: the layers the flagship shards at --mesh_model 2 (31
# classes: fc and classifier stay replicated), and (c)'s packing
TP_SHARDED = ["policy_net.joint_fc1.weight", "policy_net.joint_fc2.weight",
              "policy_net.lstm.hh.weight", "policy_net.lstm.ih.weight"]
TP_CAPACITY, TP_GROUPS = 0.5, 5


def _tp_join(cfg, url, rank, world, model, dev):
    """Join the gloo group of a ``--mp-worker`` rank at --mesh_model
    ``model``."""
    from adamml_tpu_torch.parallel import mesh

    cfg.runtime.dist_url, cfg.runtime.world_size = url, world
    cfg.runtime.rank, cfg.runtime.mesh_model = rank, model
    return mesh.init_distributed(cfg, dev, backend="gloo")


class _Collectives:
    """Counts, bytes and host ms of the collectives a step runs, by kind:
    the Dense outputs' all-gathers over the model group, the input
    gradients' all-reduces over it, and the data group's all-reduces
    (gradients, metrics) and broadcasts (BN statistics); measurement only,
    each call synchronized while it is timed."""

    def __init__(self):
        self.log = []

    def __enter__(self):
        import torch.distributed as dist

        from adamml_tpu_torch.parallel import mesh

        self.saved = (mesh._all_gather, dist.all_reduce, dist.broadcast)
        model_group = mesh.model_group()

        def timed(kind, fn, t, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t, *a, **kw)
            torch.cuda.synchronize()
            self.log.append((kind, t.numel() * t.element_size(),
                             (time.perf_counter() - t0) * 1e3))
            return out

        gather, reduce, bcast = self.saved
        mesh._all_gather = lambda t, *a, **kw: timed(
            "model_all_gather" if a[1] is model_group else "data_all_gather",
            gather, t, *a, **kw)
        dist.all_reduce = lambda t, *a, **kw: timed(
            "model_all_reduce" if kw.get("group") is model_group
            and model_group is not None else "data_all_reduce",
            reduce, t, *a, **kw)
        dist.broadcast = lambda t, *a, **kw: timed("broadcast", bcast, t,
                                                   *a, **kw)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        from adamml_tpu_torch.parallel import mesh

        mesh._all_gather, dist.all_reduce, dist.broadcast = self.saved

    def summary(self) -> dict:
        out = {}
        for kind, nbytes, ms in self.log:
            k = out.setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0})
            k["calls"] += 1
            k["bytes"] += nbytes
            k["ms"] += ms
        return out


def _tp_steps_worker(url, rank, world, args, dev, report) -> int:
    """(a) and (b) of tensor_parallel, one rank at (1, 2): the flagship at
    full width, bf16, all 8 clips on both ranks, MP_STEPS main then
    MP_STEPS policy steps, per-replica BN (one data shard: the same moments
    as --sync-bn without a host round trip a BN layer); then the tiny
    float32 config's main and policy step, compared on rank 0 with the
    single process."""
    from adamml_tpu_torch.parallel import mesh

    cfg = flagship_cfg()
    cfg.runtime.sync_bn = False
    _tp_join(cfg, url, rank, world, 2, dev)
    model, _ = build_model(cfg, dev)
    sharded = sorted(n for n, p in model.named_parameters()
                     if mesh.param_shard(p) is not None)
    state = _train_state(model, cfg)
    batches = _mp_batches(cfg, 8, MP_STEPS, 1000, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    digests, ms, collectives, trace = {}, {}, {}, None
    zero_counts()
    for phase in ("main", "policy"):
        step = _make_step(model, phase)
        digests[phase], ms[phase] = [], []
        cw = COST if phase == "policy" else [0., 0.]
        for i, (inputs, target) in enumerate(batches):
            if i == 0:  # the warm-up step: its collectives counted, timed
                with _Collectives() as col:
                    m = step(state, inputs, target, LR, P_LR, cw, seed=i)
                collectives[phase] = col.summary()
            elif phase == "main" and i == len(batches) - 1:
                held = {}
                names = _device_kernels(lambda: held.update(m=step(
                    state, inputs, target, LR, P_LR, cw, seed=i)))
                m = held["m"]
                trace = {"forward": sum(FWD_NAME in n and BWD_NAME not in n
                                        for n in names),
                         "backward": sum(BWD_NAME in n for n in names),
                         "kernels": len(names)}
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(state, inputs, target, LR, P_LR, cw, seed=i)
                torch.cuda.synchronize()
                ms[phase].append((time.perf_counter() - t0) * 1e3)
            digests[phase].append(_mp_digest(
                list(_mp_full(model).values()) + [m[k] for k in sorted(m)]))
    launches = all_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    del model, state, step
    torch.cuda.empty_cache()
    # (b) the tiny float32 config, cuDNN deterministic, real Gumbel noise
    torch.backends.cudnn.deterministic = True
    tiny = flagship_cfg(tiny=True)
    tiny.runtime.world_size, tiny.runtime.mesh_model = world, 2
    batch = _mp_batches(tiny, 8, 1, 1100, dev)[0]
    mine = _mp_tiny_run(tiny, batch, LR, 1e-5)
    mesh.shutdown()
    res = dict(sharded=sharded, digests=digests, ms_per_step=ms,
               collectives=collectives, main_step_trace=trace,
               launches=launches,
               max_memory_allocated_bytes=peak,
               tiny_digests=[_mp_digest(list(r[3].values())
                                        + [r[2][k] for k in sorted(r[2])])
                             for r in mine])
    if rank == 0:
        tiny.runtime.world_size, tiny.runtime.mesh_model = 1, 1
        theirs = _mp_tiny_run(tiny, batch, LR, 1e-5, bn_groups=1, starts=[
            (r[1][0], r[1][1], r[1][2]) for r in mine])
        res["tiny_vs_single"] = _mp_compare(mine, theirs, 1e-4, 1e-5)
    report(**res)
    return 0


def _tp_plan(dec: np.ndarray, rows: int, groups: int, capacity: float):
    """(run set, dropped selections) of packing ``dec`` (M, rows) in
    ``groups`` blocks (one when they do not divide the rows): the JAX
    package's plan (adamml_tpu/models/joint_net.py:98-121), counted here."""
    groups = groups if groups > 1 and rows % groups == 0 else 1
    bl = rows // groups
    cap = max(1, int(round(capacity * bl)))
    run, dropped = [], []
    for m in range(dec.shape[0]):
        ids, drop = [], 0
        for g in range(groups):
            blk = dec[m, g * bl:(g + 1) * bl]
            ids += list(g * bl + np.argsort(-blk, kind="stable")[:cap])
            drop += max(0, int(blk.sum()) - cap)
        run.append(sorted(ids))
        dropped.append(drop)
    return run, dropped


def _tp_inputs(cfg, dev):
    """(c)'s global batch: 8 clips folded to 40 rows a modality, and forced
    decisions (each row on with probability 0.6, seeded)."""
    s = cfg.model.num_segments
    x = example_inputs(cfg, batch=8, seed=1200, device=dev)
    m_x = [a.reshape((8 * s,) + tuple(a.shape[2:])) for a in x]
    dec = (np.random.RandomState(1201).rand(2, 8 * s) < 0.6).astype(
        np.float32)
    return m_x, dec


def _tp_packed_worker(url, rank, world, args, dev, report) -> int:
    """(c) of tensor_parallel, one rank at (2, 1): the flagship's main net
    at eval capacity 0.5 in 5 blocks of 8 of the 40 global rows (blocks 2
    spans the ranks), forced decisions, this rank's 20 rows; the gathered
    logits, the epilogue's row counts, and capacity_dropped on the gathered
    decisions."""
    from adamml_tpu_torch.parallel import mesh
    from adamml_tpu_torch.train.engine import capacity_dropped

    cfg = flagship_cfg()
    cfg.model.eval_capacity, cfg.model.capacity_groups = (TP_CAPACITY,
                                                          TP_GROUPS)
    _tp_join(cfg, url, rank, world, 1, dev)
    model, _ = build_model(cfg, dev)
    m_x, dec = _tp_inputs(cfg, dev)
    shards, index = mesh.data_world()
    n = m_x[0].shape[0] // shards
    mine = [a[index * n:(index + 1) * n] for a in m_x]
    mdec = torch.from_numpy(dec[:, index * n:(index + 1) * n]).to(dev)
    with torch.no_grad():
        zero_counts()
        rows, logits = _packed_rows(lambda: model.main_net(
            mine, mdec, seq_groups=cfg.model.num_segments))
        launches = all_counts()
    every = mesh.gather_rows(mdec, dim=1).numpy()           # (M, 40)
    s = cfg.model.num_segments
    dropped = capacity_dropped(
        [every.T.reshape(-1, s, 2)], 2, TP_CAPACITY, TP_GROUPS)
    out = mesh.gather_rows(logits).float()
    mesh.shutdown()
    report(logits=out.tolist(), rows=rows, launches=launches,
           dropped=dropped.tolist(),
           decisions_equal=bool(np.array_equal(every, dec)))
    return 0


TP_TASKS = {"tp_steps": _tp_steps_worker, "tp_packed": _tp_packed_worker}


def _mp_spawn(task, world, args) -> list:
    """``world`` processes of this script as ranks of ``task``
    (``_mp_worker``) on one rendezvous URL; each rank's output. A rank
    that fails or outlives MP_TIMEOUT_S fails the phase; every child is
    killed on the way out."""
    import subprocess

    from adamml_tpu_torch.parallel.mesh import free_local_url

    here = os.path.abspath(__file__)
    url = free_local_url()
    # stdout apart from stderr: the C++ side's warnings on stderr can land
    # in the middle of a line printed to a shared pipe
    procs = [subprocess.Popen(
        [sys.executable, here, "--mp-worker", task, url, str(r), str(world),
         json.dumps(args)], cwd=os.path.dirname(here),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        got = [p.communicate(timeout=MP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, got)):
        check(p.returncode == 0, f"multi_process {task} rank {r} exited "
                                 f"{p.returncode}:\n{(out + err)[-3000:]}")
    return [out for out, _ in got]


def _mp_results(outs) -> list:
    res = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        check(bool(lines), f"a rank printed no result:\n{out[-2000:]}")
        res.append(json.loads(lines[-1][len("RESULT "):]))
    return res


def _mp_check_compare(label, cmp) -> None:
    """The tolerances of tests/test_torch_multiprocess.py."""
    for c in cmp:
        ok = (c["exact"] and c["loss_rel"] <= 1e-5 and c["stats"] <= 2e-4
              and c["frozen_equal"] and c["moved"] > 50)
        if c["phase"] == "main":
            ok &= c["params"] <= 0.1 * LR
        else:
            ok &= (c["policy_max"] <= 2.5e-5
                   and c["close"] / c["total"] >= 0.99)
        check(ok, f"{label} {c['phase']}: 2 ranks against the single "
                  f"process: {c}")


def _mp_nccl_world1(dev, card) -> dict:
    """(a) NCCL at world size 1, in this process: the flagship at full
    width, bf16, 8 clips, MP_STEPS main then MP_STEPS policy steps with
    per-replica BN and with --sync-bn, through the distributed code (a
    process group of one: the gradient all-reduce, the metric average, the
    BN broadcast or the synchronized moments all run) against the same
    steps without a group, bit for bit after every step; then the K = 2
    replay with the collectives captured (main phase with per-replica BN:
    gradients, metrics and BN statistics; policy phase under --sync-bn:
    the moments' all-reduce in the forward and backward) against K single
    steps (_replay_vs_eager)."""
    from adamml_tpu_torch.parallel import mesh

    cfg = flagship_cfg()
    batches = _mp_batches(cfg, 8, MP_STEPS, 700, dev)

    def run(sync):
        cfg.runtime.sync_bn = sync
        model, _ = build_model(cfg)
        state = _train_state(model, cfg)
        snaps, ms = [], []
        for phase in ("main", "policy"):
            step = _make_step(model, phase)
            for i, (inputs, target) in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(state, inputs, target, LR, P_LR,
                         COST if phase == "policy" else [0., 0.], seed=i)
                torch.cuda.synchronize()
                ms.append((phase, i, (time.perf_counter() - t0) * 1e3))
                snaps.append([t.clone() for t in _mp_state(model, m)])
        synced = [getattr(b, "sync", False) for b in model.modules()
                  if hasattr(b, "running_mean")]
        del model, state, step
        return snaps, ms, synced

    ref = {sync: run(sync) for sync in (False, True)}
    cfg.runtime.dist_url = mesh.free_local_url()
    got_mesh = mesh.init_distributed(cfg, dev)
    out = {"backend": got_mesh.backend, "world": got_mesh.world,
           "nccl_version": str(torch.cuda.nccl.version())}
    check(got_mesh.backend == "nccl" and got_mesh.world == 1,
          f"the group of one is {got_mesh}")
    try:
        zero_counts()
        got = {sync: run(sync) for sync in (False, True)}
        out["launches"] = all_counts()
        for sync in (False, True):
            mode = "sync_bn" if sync else "per_replica_bn"
            unequal = [i for i, (a, b) in enumerate(zip(got[sync][0],
                                                         ref[sync][0]))
                       if not all(torch.equal(x, y) for x, y in zip(a, b))]
            check(not unequal, f"nccl world 1 {mode}: steps {unequal} differ "
                               f"from the steps without a group")
            check(all(got[sync][2]) == sync and not any(ref[sync][2]),
                  f"nccl world 1 {mode}: BN sync marks {set(got[sync][2])}")
            out[mode] = {"steps_bit_equal": len(got[sync][0]),
                         "ms_per_step_group": got[sync][1],
                         "ms_per_step_no_group": ref[sync][1]}
        del got, ref
        torch.cuda.empty_cache()
        cfg.runtime.sync_bn = False
        out["replay_main_per_replica_bn"] = _replay_vs_eager(
            cfg, "main", 8, dev, "multi_process_nccl_replay")
        cfg.runtime.sync_bn = True
        out["replay_policy_sync_bn"] = _replay_vs_eager(
            cfg, "policy", 8, dev, "multi_process_nccl_replay")
    finally:
        mesh.shutdown()
    emit("multi_process", check="nccl_world_1", card=card,
         **{k: v for k, v in out.items() if not k.startswith("replay")})
    torch.cuda.empty_cache()
    return out


def _median_after_first(ms) -> float:
    return float(np.median([t for phase, i, t in ms if i]))


def _mp_gloo_world2(card, nccl) -> dict:
    """(b) World size 2 on the one card: two processes share cuda:0 over
    gloo, the flagship at full width with a global batch of 8, 4 rows a
    rank, MP_STEPS main and MP_STEPS policy steps with per-replica BN and
    with --sync-bn: both ranks bit-identical after every step, each rank's
    device trace of a main step with 3 forward and 3 backward epilogue
    kernels; the gradient all-reduce's bytes and ms, ms per step against
    world size 1 (the single process of (a), 8 rows) and peak memory per
    rank. Then the tiny float32 config (cuDNN deterministic, real Gumbel
    noise): the 2-rank steps against the single process at bn_groups 2,
    or 1 under --sync-bn, from the same start."""
    t0 = time.perf_counter()
    res = _mp_results(_mp_spawn("steps", 2, {"device": "cuda:0"}))
    seconds = time.perf_counter() - t0
    a, b = res
    out = {}
    for mode in ("per_replica_bn", "sync_bn"):
        check(a[mode]["digests"] == b[mode]["digests"],
              f"gloo world 2 {mode}: the ranks differ: "
              f"{a[mode]['digests']} {b[mode]['digests']}")
        check(a[mode]["synced"] == b[mode]["synced"] == (mode == "sync_bn"),
              f"gloo world 2 {mode}: BN sync marks")
        for r in res:
            tr = r[mode]["main_step_trace"]
            check(tr["forward"] == 3 and tr["backward"] == 3,
                  f"gloo world 2 {mode} rank {r['rank']}: main step trace "
                  f"{tr}, expected 3 forward and 3 backward epilogue kernels")
        w2 = [t for r in res for ph in ("main", "policy")
              for t in r[mode]["ms_per_step"][ph][1:]]
        out[mode] = dict(
            steps_bit_identical=2 * MP_STEPS,
            main_step_trace=[r[mode]["main_step_trace"] for r in res],
            median_ms_per_step_world2=float(np.median(w2)),
            median_ms_per_step_world1=_median_after_first(
                nccl[mode]["ms_per_step_no_group"]),
            ms_per_step_world2=[r[mode]["ms_per_step"] for r in res],
            allreduce_bytes=a[mode]["allreduce_bytes"],
            allreduce_ms=[r[mode]["allreduce_ms"] for r in res],
            max_memory_allocated_bytes=[r[mode]["max_memory_allocated_bytes"]
                                        for r in res])
    check(a["tiny_digests"] == b["tiny_digests"],
          "gloo world 2 tiny: the ranks differ")
    for key in ("tiny_per_replica_bn_vs_single", "tiny_sync_bn_vs_single"):
        _mp_check_compare(key, a[key])
        out[key] = a[key]
    emit("multi_process", check="gloo_world_2", card=card, seconds=seconds,
         **out, timing="host clock around each step ending in "
         "torch.cuda.synchronize(); the first step of each phase left out "
         "of the medians; world 1 is (a)'s single process on 8 rows, world "
         "2 two processes of 4 rows sharing the card; all-reduce: "
         "dist.all_reduce of a float32 buffer of the main net's size, 3 "
         "after 1 warm-up")
    return out


def _mp_lines(out, prefix) -> list:
    return [ln.split(" ", 1)[1] for ln in out.splitlines()
            if ln.startswith(prefix + " ")]


def _mp_val_lines(out, rank) -> list:
    """The Val lines a rank printed, without the per-rank speed."""
    import re

    tag = "Val: " if rank == 0 else f"[rank {rank}] Val: "
    return [re.sub(r"Speed: [0-9.]+ ms/batch\t", "", ln[len(tag) - 5:])
            for ln in out.splitlines() if ln.startswith(tag)]


def _mp_cli(card) -> dict:
    """(c) Both CLIs at world size 2 on the card, two processes with
    --dist-url --world-size 2 --rank r --dist-backend gloo --gpu 0:
    train_unimodal rgb ResNet-50 on 13 synthetic videos, and the
    flagship curriculum (FLAGSHIP_FLAGS, 16 videos, 1 epoch a stage). Both
    ranks print the same Val lines; every gathered validation has the
    dataset's rows; only rank 0 writes checkpoints; finetune loads
    model_best on both ranks when one was written."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for cli, argv, rows in (
                ("train_unimodal", MP_UNIMODAL, 13),
                ("train_adamml", CLI_ADAMML, 16)):
            logdir = os.path.join(tmp, cli)
            t0 = time.perf_counter()
            outs = _mp_spawn("cli", 2, {"cli": cli, "device": "cuda:0",
                                        "argv": argv + ["--logdir", logdir]})
            seconds = time.perf_counter() - t0
            val = [_mp_val_lines(o, r) for r, o in enumerate(outs)]
            check(bool(val[0]) and val[0] == val[1],
                  f"{cli} world 2: Val lines differ: {val}")
            got_rows = [[int(x.split()[1]) for x in _mp_lines(o, "VALROWS")]
                        for o in outs]
            check(got_rows[0] == got_rows[1]
                  and set(got_rows[0]) == {rows},
                  f"{cli} world 2: validation rows {got_rows}, expected "
                  f"{rows}")
            writes = [_mp_lines(o, "CKPT_WRITE") for o in outs]
            check(bool(writes[0]) and not writes[1],
                  f"{cli} world 2: checkpoint writes {writes}")
            folder = os.path.join(logdir, os.listdir(logdir)[0])
            best = os.path.exists(os.path.join(folder, "model_best"))
            loads = [_mp_lines(o, "LOADED") for o in outs]
            if cli == "train_adamml":
                check(all(any(ln.endswith("model_best") for ln in ls) == best
                          for ls in loads),
                      f"train_adamml world 2: model_best written {best}, "
                      f"loads {loads}")
            out[cli] = dict(seconds=seconds, val_lines=val[0],
                            val_rows=got_rows[0], checkpoint_writes=writes,
                            model_best=best, loads=loads)
            emit("multi_process", check=f"cli_world_2_{cli}", card=card,
                 **out[cli])
    return out


def _mp_cli_spawn(card) -> dict:
    """train_unimodal with --multiprocessing-distributed, as a user runs
    it: one process per visible card (NCCL, a group of one here)."""
    import subprocess

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "adamml_tpu_torch.cli.train_unimodal",
             *MP_SPAWN, "--logdir", os.path.join(tmp, "spawn")],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=MP_TIMEOUT_S)
        val = _mp_val_lines(p.stdout, 0)
        check(p.returncode == 0 and len(val) == 1,
              f"--multiprocessing-distributed: exit {p.returncode}, Val "
              f"lines {val}:\n{(p.stdout + p.stderr)[-3000:]}")
        out = dict(seconds=time.perf_counter() - t0,
                   processes=torch.cuda.device_count(), val_line=val[0])
    emit("multi_process", check="cli_multiprocessing_distributed",
         card=card, argv=MP_SPAWN, **out)
    return out


def multi_process_phase(dev, card: str) -> dict:
    """Data-parallel runs (parallel/mesh.py): (a) NCCL at world size 1,
    (b) world size 2 over gloo on the one card, (c) both CLIs at world size
    2 and --multiprocessing-distributed. The kernels are built before any
    rank starts (two ranks building into _build/ at once would race)."""
    out = {"nccl": _mp_nccl_world1(dev, card)}
    out["gloo"] = _mp_gloo_world2(card, out["nccl"])
    out["cli"] = _mp_cli(card)
    out["spawn"] = _mp_cli_spawn(card)
    torch.cuda.empty_cache()
    return out


def _tp_a_b(card, world1) -> dict:
    """(a) the flagship at (1, 2): ranks bit-identical after every step,
    the sharded set, each rank's main-step epilogue kernels, ms per step
    against world size 1 (``world1``: multi_process (a)'s steps without a
    group, 8 clips, per-replica BN), the collectives' bytes and ms, peak
    memory per rank; (b) the tiny config against the single process."""
    t0 = time.perf_counter()
    a, b = _mp_results(_mp_spawn("tp_steps", 2, {"device": "cuda:0"}))
    seconds = time.perf_counter() - t0
    check(a["digests"] == b["digests"],
          f"tensor_parallel (1, 2): the ranks' gathered states differ: "
          f"{a['digests']} {b['digests']}")
    for r in (a, b):
        check(r["sharded"] == TP_SHARDED, f"tensor_parallel rank "
              f"{r['rank']}: sharded {r['sharded']}, expected {TP_SHARDED}")
        tr = r["main_step_trace"]
        check(tr["forward"] == 3 and tr["backward"] == 3,
              f"tensor_parallel rank {r['rank']}: main step trace {tr}, "
              f"expected 3 forward and 3 backward epilogue kernels")
        # host counts over the rank's steps: 3 forward a step, 3 backward
        # a main-phase step
        got = (r["launches"][tp.KERNEL], r["launches"][tp.KERNEL_BWD])
        check(got == (6 * MP_STEPS, 3 * MP_STEPS),
              f"tensor_parallel rank {r['rank']}: epilogue launches {got}, "
              f"expected {(6 * MP_STEPS, 3 * MP_STEPS)}")
    check(a["tiny_digests"] == b["tiny_digests"],
          "tensor_parallel tiny: the ranks differ")
    _mp_check_compare("tensor_parallel tiny (1, 2)", a["tiny_vs_single"])
    w2 = [t for r in (a, b) for ph in ("main", "policy")
          for t in r["ms_per_step"][ph]]
    out = dict(sharded=a["sharded"], steps_bit_identical=2 * MP_STEPS,
               main_step_trace=[r["main_step_trace"] for r in (a, b)],
               launches=[r["launches"] for r in (a, b)],
               median_ms_per_step_tp=float(np.median(w2)),
               median_ms_per_step_world1=_median_after_first(world1),
               ms_per_step_tp=[r["ms_per_step"] for r in (a, b)],
               collectives_first_step=[r["collectives"] for r in (a, b)],
               max_memory_allocated_bytes=[r["max_memory_allocated_bytes"]
                                           for r in (a, b)],
               tiny_vs_single=a["tiny_vs_single"], seconds=seconds)
    emit("tensor_parallel", check="flagship_1x2", card=card, **out,
         timing="host clock around each step ending in "
         "torch.cuda.synchronize(); the first step of each phase (its "
         "collectives synchronized and timed one by one) and the traced "
         "main step left out; world 1 is multi_process (a)'s single "
         "process on the same 8 clips; two processes share the card over "
         "gloo, each running every clip")
    return out


def _tp_c(card) -> dict:
    """(c) A.21 at (2, 1): packed eval with blocks that span the ranks,
    against the single process at G = 5 in this process."""
    cfg = flagship_cfg()
    cfg.model.eval_capacity, cfg.model.capacity_groups = (TP_CAPACITY,
                                                          TP_GROUPS)
    t0 = time.perf_counter()
    res = _mp_results(_mp_spawn("tp_packed", 2, {"device": "cuda:0"}))
    seconds = time.perf_counter() - t0
    model, _ = build_model(cfg)
    m_x, dec = _tp_inputs(cfg, torch.device("cuda", 0))
    with torch.no_grad():
        want = model.main_net(m_x, torch.from_numpy(dec).cuda(),
                              seq_groups=cfg.model.num_segments).float()
    rows = dec.shape[1]
    run, host_dropped = _tp_plan(dec, rows, TP_GROUPS, TP_CAPACITY)
    got = torch.tensor(res[0]["logits"], device=want.device)
    check(res[0]["logits"] == res[1]["logits"],
          "tensor_parallel (2, 1): the ranks gathered other logits")
    # a rank runs its backbones on its own rows of the run set, so cuDNN
    # sees other batch sizes than the single process and may sum in
    # another order: each modality's bf16 logit can move by an ulp, and
    # the float32 late-fusion sum of the two can add them
    ulp = float(bf16_ulp(want.abs().max()))
    diff = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and diff <= 2 * ulp,
          f"tensor_parallel (2, 1): packed logits differ from the single "
          f"process at G = {TP_GROUPS} by {diff}, beyond 2 bf16 ulps of the "
          f"largest logit ({2 * ulp})")
    half = rows // 2
    for r in res:
        lo, hi = r["rank"] * half, (r["rank"] + 1) * half
        n_rgb = sum(lo <= i < hi for i in run[0])
        check(r["decisions_equal"], f"rank {r['rank']}: gathered decisions")
        check(r["rows"] == ([n_rgb] * 3 if n_rgb else []),
              f"tensor_parallel (2, 1) rank {r['rank']}: epilogue launches "
              f"on rows {r['rows']}, the plan runs {n_rgb} rgb rows here")
        check(r["dropped"] == host_dropped,
              f"tensor_parallel (2, 1) rank {r['rank']}: capacity_dropped "
              f"{r['dropped']}, counted here {host_dropped}")
    out = dict(rows=rows, groups=TP_GROUPS, capacity=TP_CAPACITY,
               run_rows=[len(x) for x in run],
               rows_launched=[r["rows"] for r in res],
               launches=[r["launches"] for r in res],
               capacity_dropped=res[0]["dropped"], host_count=host_dropped,
               max_abs_logit=float(want.abs().max()), max_abs_diff=diff,
               diff_in_bf16_ulps_of_largest=diff / ulp, seconds=seconds)
    emit("tensor_parallel", check="packed_eval_2x1", card=card, **out)
    del model
    torch.cuda.empty_cache()
    return out


def _tp_d(card) -> dict:
    """(d) train_adamml at --world-size 2 --mesh_model 2 on 16 synthetic
    videos: equal Val lines, checkpoints from rank 0 only and unsharded;
    then -e --pretrained on that checkpoint at (1, 2) and at world size 1
    in this process give the same Val line (float32 there, so that no
    Gumbel decision sits within a bf16 rounding of its tie)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        logdir = os.path.join(tmp, "tp")
        t0 = time.perf_counter()
        outs = _mp_spawn("cli", 2, {"cli": "train_adamml", "device": "cuda:0",
                                    "argv": CLI_ADAMML + [
                                        "--mesh_model", "2", "--logdir",
                                        logdir]})
        seconds = time.perf_counter() - t0
        val = [_mp_val_lines(o, r) for r, o in enumerate(outs)]
        check(bool(val[0]) and val[0] == val[1],
              f"train_adamml (1, 2): Val lines differ: {val}")
        writes = [_mp_lines(o, "CKPT_WRITE") for o in outs]
        check(bool(writes[0]) and not writes[1],
              f"train_adamml (1, 2): checkpoint writes {writes}")
        folder = os.path.join(logdir, os.listdir(logdir)[0])
        ckpt = os.path.join(folder, "checkpoint")
        saved = torch.load(os.path.join(ckpt, "state.pt"),
                           map_location="cpu", weights_only=True)["model"]
        full, _ = build_model(flagship_cfg())
        shapes = {k: tuple(v.shape) for k, v in full.state_dict().items()}
        del full
        check({k: tuple(v.shape) for k, v in saved.items()} == shapes,
              "train_adamml (1, 2): the checkpoint is not the full model")
        ev = CLI_ADAMML + ["-e", "--pretrained", ckpt, "--compute_dtype",
                           "float32"]
        outs = _mp_spawn("cli", 2, {"cli": "train_adamml", "device": "cuda:0",
                                    "argv": ev + ["--mesh_model", "2",
                                                  "--logdir",
                                                  os.path.join(tmp, "e2")]})
        e_tp = [_mp_val_lines(o, r) for r, o in enumerate(outs)]
        run = _run_cli(train_adamml.main, ev, os.path.join(tmp, "e1"))
        e_one = _mp_val_lines("\n".join(msg for _, msg in run["probe"].lines),
                              0)
        check(bool(e_one) and e_tp[0] == e_tp[1] == e_one,
              f"-e --pretrained: Val at (1, 2) {e_tp}, at world size 1 "
              f"{e_one}")
        out = dict(seconds=seconds, val_lines=val[0], checkpoint_writes=writes,
                   evaluate_val_line=e_one, sharded_in_checkpoint={
                       k: list(saved[k].shape) for k in TP_SHARDED})
    emit("tensor_parallel", check="cli_train_adamml_1x2", card=card, **out)
    return out


def tensor_parallel_phase(card: str, world1) -> dict:
    """Tensor parallelism (--mesh_model, parallel/mesh.py) and packing
    across ranks on the one card, every rank a process over gloo: (a) and
    (b) at (1, 2), (c) at (2, 1), (d) the CLI at (1, 2)."""
    t0 = time.perf_counter()
    out = {"steps": _tp_a_b(card, world1), "packed": _tp_c(card),
           "cli": _tp_d(card)}
    emit("tensor_parallel", check="phase", seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mp-worker"]:
        return _mp_worker(sys.argv[2:])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit("device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    kernels = [tp.KERNEL, tp.KERNEL_BWD, dwk.KERNEL, tpp.KERNEL, tbn.SOURCE]
    t0 = time.perf_counter()
    build.build(kernels)
    ptxas = {k: [ln.strip() for ln in build.build_log(k).splitlines()
                 if "Used" in ln or "spill" in ln] for k in kernels}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    one_kernel_phase(dev)
    kres = kernel_phase(dev)
    bres = kernel_bwd_phase(dev)
    bnres = bn_kernel_phase(dev)
    sres = serve_phase(dev, smi)
    tres = train_phase(dev, smi)
    train_vs_plain_phase(dev)
    sdw = serve_phase(dev, smi, use_pallas_dw=True)
    # with the flag each depthwise layer puts one kernel on the card, where
    # cuDNN's depthwise convolution puts one or more
    extra = sdw["kernels_per_step"] - sres["kernels_per_step"]
    check(extra <= 5, f"an eval step with use_pallas_dw=True puts "
          f"{sdw['kernels_per_step']} kernels on the card, the default "
          f"path {sres['kernels_per_step']}: more than 5 more")
    emit("serve_dw_kernels", default=sres["kernels_per_step"],
         use_pallas_dw=sdw["kernels_per_step"], difference=extra)
    tdw = train_phase(dev, smi, use_pallas_dw=True)
    mres = multi_step_phase(dev, smi)
    eres = eval_capacity_phase(dev, smi)
    dres = kernel_dw_phase(dev, sdw["dw_layers"])
    tiny_reference_phase(dev)
    tiny_train_phase(dev)
    tiny_reference_phase(dev, use_pallas_dw=True)
    tiny_train_phase(dev, use_pallas_dw=True)
    ores = tools_phase(dev)
    ures = update_mem_phase(dev, smi,
                            tres["peak"]["main"] - tres["held"]["main"])
    preprocess_phase(dev)
    cres = cli_phase(dev, smi)
    rres = real_data_phase(dev, smi)
    pres = multi_process_phase(dev, smi)
    tpres = tensor_parallel_phase(
        smi, pres["nccl"]["per_replica_bn"]["ms_per_step_no_group"])

    def bound_by(res):
        return "bytes" if res["bytes_s"] >= res["ops_s"] else "operations"

    print(json.dumps({"kernels": [{
        "name": tp.KERNEL, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/tpool_fused.cu",
        "replaces": "adamml_tpu/ops/pallas/tpool_fused.py:71",
        "also_replaces": ["adamml_tpu/ops/pallas/tpool_fused.py:345"],
        "launches": sres["launches"][tp.KERNEL],
        "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"], "plain_ms": kres["plain_ms"],
        "bound_ms": kres["bound_ms"], "bound_by": bound_by(kres),
        "library_ms": None,
        "launches_by_path": {
            "serve": sres["launches"][tp.KERNEL],
            "train_main": tres["main"][tp.KERNEL],
            "train_policy": tres["policy"][tp.KERNEL],
            "serve_dw": sdw["launches"][tp.KERNEL],
            "train_dw_main": tdw["main"][tp.KERNEL],
            "train_dw_policy": tdw["policy"][tp.KERNEL],
            "cli_train_adamml": cres["train_adamml"][tp.KERNEL],
            "cli_train_adamml_evaluate":
                cres["train_adamml_evaluate"][tp.KERNEL],
            "cli_train_unimodal": cres["train_unimodal"][tp.KERNEL],
            "real_data_train_unimodal_rgb":
                rres["train_unimodal_rgb"][tp.KERNEL],
            "real_data_train_adamml": rres["train_adamml"][tp.KERNEL],
            "real_data_train_adamml_evaluate":
                rres["train_adamml_evaluate"][tp.KERNEL],
            "multi_step_main_capture": mres["main"]["capture"][tp.KERNEL],
            "multi_step_main_replay_trace":
                mres["main"]["trace"]["replay"]["forward"],
            "multi_step_policy_capture":
                mres["policy"]["capture"][tp.KERNEL],
            "multi_step_policy_replay_trace":
                mres["policy"]["trace"]["replay"]["forward"],
            "cli_train_adamml_multi": cres["train_adamml_multi"][tp.KERNEL],
            "cli_train_adamml_multi_traces": [
                t["forward"] for t in cres["train_adamml_multi_traces"]],
            "multi_process_nccl_world1": pres["nccl"]["launches"][tp.KERNEL],
            "multi_process_gloo_world2_main_step_trace_per_rank": [
                t["forward"] for t in
                pres["gloo"]["per_replica_bn"]["main_step_trace"]],
            "tensor_parallel_1x2_main_step_trace_per_rank": [
                t["forward"] for t in tpres["steps"]["main_step_trace"]],
            "tensor_parallel_1x2_steps_per_rank": [
                c[tp.KERNEL] for c in tpres["steps"]["launches"]],
            "tensor_parallel_2x1_packed_eval_per_rank": [
                c[tp.KERNEL] for c in tpres["packed"]["launches"]],
            "update_mem_mem_analysis": ures["launches"][tp.KERNEL],
            **{f"eval_capacity_{k}": v[tp.KERNEL]
               for k, v in eres["launches"].items()}},
        "packed_rows": eres["kernel"],
        "note": "ms, plain_ms and bound_ms are sums over the three "
                "flagship stage boundaries of one 8-clip eval step "
                "(packed_rows: the same at N = 20 and 10); launches are "
                "the serve path's (5 batches); a captured launch counts "
                "once and a replayed one not (the *_trace entries count "
                "one replay's kernels in a device trace)"}, {
        "name": tp.KERNEL_BWD, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/tpool_fused_bwd.cu",
        "replaces": "adamml_tpu/ops/pallas/tpool_fused.py:92",
        "also_replaces": ["adamml_tpu/ops/pallas/tpool_fused.py:402"],
        "launches": tres["main"][tp.KERNEL_BWD],
        "max_abs_err": bres["max_abs_err"],
        "ms": bres["ms"], "plain_ms": bres["plain_ms"],
        "bound_ms": bres["bound_ms"], "bound_by": bound_by(bres),
        "library_ms": None,
        "launches_by_path": {
            "train_main": tres["main"][tp.KERNEL_BWD],
            "train_policy": tres["policy"][tp.KERNEL_BWD],
            "train_dw_main": tdw["main"][tp.KERNEL_BWD],
            "train_dw_policy": tdw["policy"][tp.KERNEL_BWD],
            "cli_train_adamml": cres["train_adamml"][tp.KERNEL_BWD],
            "cli_train_unimodal": cres["train_unimodal"][tp.KERNEL_BWD],
            "real_data_train_unimodal_rgb":
                rres["train_unimodal_rgb"][tp.KERNEL_BWD],
            "real_data_train_adamml": rres["train_adamml"][tp.KERNEL_BWD],
            "multi_step_main_capture":
                mres["main"]["capture"][tp.KERNEL_BWD],
            "multi_step_main_replay_trace":
                mres["main"]["trace"]["replay"]["backward"],
            "multi_step_policy_replay_trace":
                mres["policy"]["trace"]["replay"]["backward"],
            "cli_train_adamml_multi":
                cres["train_adamml_multi"][tp.KERNEL_BWD],
            "cli_train_adamml_multi_traces": [
                t["backward"] for t in cres["train_adamml_multi_traces"]],
            "multi_process_nccl_world1":
                pres["nccl"]["launches"][tp.KERNEL_BWD],
            "multi_process_gloo_world2_main_step_trace_per_rank": [
                t["backward"] for t in
                pres["gloo"]["per_replica_bn"]["main_step_trace"]],
            "tensor_parallel_1x2_main_step_trace_per_rank": [
                t["backward"] for t in tpres["steps"]["main_step_trace"]],
            "tensor_parallel_1x2_steps_per_rank": [
                c[tp.KERNEL_BWD] for c in tpres["steps"]["launches"]],
            "update_mem_mem_analysis": ures["launches"][tp.KERNEL_BWD],
            "tools": ores["launches"][tp.KERNEL_BWD]},
        "dab_max_rel_err": bres["dab_max_rel_err"],
        "per_stage": bres["stages"], "ptxas": bres["ptxas"],
        "note": "ms, plain_ms and bound_ms are sums over the three "
                "flagship stage boundaries of one 8-clip main-phase step "
                "(per_stage: each boundary, with the kernel's registers, "
                "blocks an SM and partials bytes); max_abs_err is dy's and "
                "dident's; launches are the main-phase train path's (4 "
                "steps)"}, {
        "name": dwk.KERNEL, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/depthwise.cu",
        "replaces": "adamml_tpu/ops/pallas/depthwise.py:78",
        "launches": sdw["launches"][dwk.KERNEL],
        "max_abs_err": dres["max_abs_err"],
        "ms": dres["ms"], "call_ms": dres["call_ms"],
        "plain_ms": dres["plain_ms"],
        "bound_ms": dres["bound_ms"], "bound_by": bound_by(dres),
        "library_ms": dres["library_ms"],
        "stride1": _dw_sum_line(dres["s1"]),
        "stride2": _dw_sum_line(dres["s2"]),
        "launches_by_path": {
            "serve_dw": sdw["launches"][dwk.KERNEL],
            "train_dw_main": {"forward": tdw["main"][dwk.KERNEL],
                              "input_gradient": tdw["main"][dwk.KERNEL_DX]},
            "train_dw_policy": {
                "forward": tdw["policy"][dwk.KERNEL],
                "input_gradient": tdw["policy"][dwk.KERNEL_DX]},
            "multi_step_tiny_dw_policy_capture": {
                "forward": mres["tiny_dw_policy"]["capture"][dwk.KERNEL],
                "input_gradient":
                    mres["tiny_dw_policy"]["capture"][dwk.KERNEL_DX]},
            "multi_step_tiny_dw_policy_replay_trace":
                mres["tiny_dw_policy"]["trace"]["replay"]["depthwise"],
            "tools": ores["launches"][dwk.KERNEL]},
        "note": "ms (the kernel alone), call_ms (depthwise_conv3x3 as "
                "the model calls it), plain_ms, bound_ms and library_ms "
                "are sums over the 51 depthwise layers of one 8-clip eval "
                "step with use_pallas_dw=True (library: cuDNN's depthwise "
                "convolution, F.pad first at stride 2); launches are the "
                "serve_dw path's (5 batches)"}, {
        "name": tpp.KERNEL, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/tpool_proto.cu",
        "replaces": "tools/bench_tpool.py:53",
        "launches": ores["launches"][tpp.KERNEL],
        "max_abs_err": ores["proto_max_abs_err"],
        "ms": ores["ms"], "plain_ms": ores["plain_ms"],
        "bound_ms": ores["bound_ms"], "bound_by": bound_by(ores),
        "library_ms": None,
        "launches_by_path": {"tools": ores["launches"][tpp.KERNEL]},
        "note": "ms, plain_ms and bound_ms are sums over bench_tpool's "
                "three stage shapes at batch 8; launches are the tools "
                "path's (timing runs included)"}, {
        "name": tbn.SOURCE, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/bn_train.cu",
        "replaces": None,
        "kernels": list(tbn.KERNELS),
        "launches": bnres["launches"],
        "max_abs_err": bnres["max_abs_err"],
        "tolerance": BN_TOLERANCE,
        "ms": bnres["ms"], "plain_ms": bnres["plain_ms"],
        "bound_ms": bnres["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "launches_by_path": {
            "serve": bn_counts(sres["launches"]),
            "train_main": bn_counts(tres["main"]),
            "train_policy": bn_counts(tres["policy"]),
            "train_dw_main": bn_counts(tdw["main"]),
            "train_dw_policy": bn_counts(tdw["policy"]),
            "cli_train_adamml": bn_counts(cres["train_adamml"]),
            "cli_train_adamml_evaluate":
                bn_counts(cres["train_adamml_evaluate"]),
            "cli_train_unimodal": bn_counts(cres["train_unimodal"]),
            "real_data_train_unimodal_rgb":
                bn_counts(rres["train_unimodal_rgb"]),
            "real_data_train_adamml": bn_counts(rres["train_adamml"]),
            "multi_step_main_capture": bn_counts(mres["main"]["capture"]),
            "multi_step_policy_capture":
                bn_counts(mres["policy"]["capture"]),
            "cli_train_adamml_multi": bn_counts(cres["train_adamml_multi"]),
            "multi_process_nccl_world1": bn_counts(pres["nccl"]["launches"]),
            "tensor_parallel_1x2_steps_per_rank": [
                bn_counts(c) for c in tpres["steps"]["launches"]],
            "update_mem_mem_analysis": bn_counts(ures["launches"])},
        "note": "no Pallas kernel: the JAX package leaves train-mode BN "
                "to XLA; ms, plain_ms and bound_ms are sums over the BN "
                "calls of one 18-clip flagship main-phase step (the "
                "finalize kernels count no bound bytes); launches are "
                "that step's; max_abs_err is each kernel's largest over "
                "those calls' shapes (sums' errors scale with the sums); "
                "the train paths' launches are checked against their "
                "train-mode BN calls"}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
