#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adamml_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (or several):

  device      card name, count, and nvidia-smi's name and power limit;
  build       nvcc builds every CUDA kernel from csrc/ (one process per
              source, all at once) and prints ptxas' registers, shared
              memory, spills;
  one_kernel_a_call  torch.profiler's count of kernels in one depthwise
              forward call and one stride-1 input-gradient call (one
              each), before any other profiled run;
  kernel      the fused epilogue's forward kernel against its plain PyTorch
              version, at the flagship eval shapes and at grouped, float32
              and odd-F cases, with CUDA-event times beside the bound;
  kernel_bwd  the backward kernel against its plain version, at the three
              flagship train shapes (R = 1, S = 5), float32, odd F, R = 2
              and an engineered tie, with the same timings;
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
              just before each phase and read just after; checks on losses,
              decisions, which parameters and statistics moved;
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
              then both kernel tools (adamml_tpu_torch/tools/bench_depthwise
              and bench_tpool) at their shapes;
  preprocess_card_vs_cpu  one flagship synthetic batch through the device
              preprocessing on the card and on the CPU (float32, 1e-3);
  cli         both training CLIs in process, as a user runs them:
              train_adamml at the flagship's full width through warmup,
              alternating and finetune on 16 synthetic videos, then its -e
              evaluation, then train_unimodal (rgb ResNet-50); launch
              counts zeroed before each run and read after, and every
              epoch's epilogue launches checked; stage seconds, the
              engine's ms/batch, data ms/batch and peak memory;
  real_data   the paper's recipe on real files: a kinetics-sounds tree
              generated here (16 videos of 64 JPEGs at 256x340, 24 kHz
              WAVs, one video without its WAV), the decoder that loads
              and its ms per frame, one real batch's preprocessing on the
              card against the CPU, train_unimodal rgb and sound, the
              flagship curriculum with --unimodality_pretrained (graft
              checked bit for bit), then -e --pretrained (tensors and
              temperature checked); every epoch's epilogue launches and
              every JPEG's decoder counted;
  kernels     one object per ported kernel, as in PERF.md's table.

Then nvidia-smi's name and power limit, and last
{"ok": true, "device": {...}}. Any failed check raises and the script exits
non-zero without that line. Without CUDA it exits 1 and prints no result.
TF32 is off for convolutions and matmuls, since float32 results are
compared with the plain versions and with the CPU.
"""

from __future__ import annotations

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
from adamml_tpu_torch.ops.augment import policy_stream
from adamml_tpu_torch.ops.kernels import build
from adamml_tpu_torch.ops.kernels import depthwise as dwk
from adamml_tpu_torch.ops.kernels import tpool_fused as tp
from adamml_tpu_torch.ops.kernels import tpool_proto as tpp
from adamml_tpu_torch.tools import (bench_depthwise, bench_pipeline,
                                    bench_tpool)
from adamml_tpu_torch.tools.timing import (F32_OPS_PER_S, HBM_BYTES_PER_S,
                                           bound_ms, event_ms,
                                           l2_flush_buffer, nvidia_smi,
                                           within_one_bf16_ulp)
from adamml_tpu_torch.train import curriculum as cur
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.steps import (make_adamml_eval_step,
                                          make_adamml_train_step)
from adamml_tpu_torch.train.train_state import (EvalState, StageFlags,
                                                TrainState)
from adamml_tpu_torch.utils.logging import RankZeroLogger

# the train step's settings (bench.py:156-161)
LR, P_LR, COST, GAMMAS = 1e-3, 1e-2, [1.0, 0.05], 10.0
COUNTS = (tp.launch_counts, dwk.launch_counts, tpp.launch_counts)
# depthwise launches (forward, input gradient) of one flagship step with
# use_pallas_dw=True: 17 layers in each of three MobileNetV2s; the main
# phase adds the audio backbone's 13 stride-1 input gradients; the policy
# phase adds the two trunks' forward again (remat) and their 26
DW_STEP = {"eval": (51, 0), "main": (51, 13), "policy": (85, 26)}
# marker kernels before and after a profiled call (_device_kernels)
MARKERS = 32


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
    return res


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


def kernel_bwd_phase(dev) -> dict:
    """The backward kernel against reference_bwd. dy and dident within one
    bf16 ulp (float32: 1e-6 relative); the kernel rounds where the plain
    version does, so both are expected bit-equal. da and db within 1e-4 of
    their largest entry: float32 sums of up to F*H*W*N/(R*S) terms (200,704
    at stage 1) taken in another order."""
    gen = torch.Generator(device=dev).manual_seed(10)
    flush = l2_flush_buffer(dev)
    res = {"max_abs_err": 0.0, "dab_max_rel_err": 0.0, "ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "bytes_s": 0.0, "ops_s": 0.0,
           "stages": {}}
    cases = BWD_CASES + [("ties", 2, 4, 8, 8, 8, 1, 1, torch.bfloat16,
                          False)]
    for label, n, f, h, w, c, r, s, dtype, timed in cases:
        y, ident, a, b, ct = _bwd_case_inputs(label, n, f, h, w, c, r, s,
                                              dtype, gen, dev)
        got = tp.fused_bn_add_relu_tpool_bwd(y, ident, a, b, ct)
        want = tp.reference_bwd(y, ident, a, b, ct)
        torch.cuda.synchronize()
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
                        else "1e-6 relative") + "; da, db: 1e-4 of max")
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
            res["ms"] += k_ms
            res["plain_ms"] += p_ms
            res["bound_ms"] += bound
            res["bytes_s"] += bytes_s
            res["ops_s"] += ops_s
        emit("kernel_bwd", **line)
        del y, ident, a, b, ct, got, want
    torch.cuda.empty_cache()
    return res


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
    runs them. Returns each phase's launches."""
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
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # this path: counts zeroed just before, read just after
        zero_counts()
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
             max_memory_allocated_bytes=peak, launches=launches,
             losses=losses, moved=moved,
             selection_rate=float(torch.stack(seen[-4:]).mean()),
             timing="host clock around each step, ending in "
                    "torch.cuda.synchronize()")
        out[phase] = launches
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
    """Names of the kernels ``fn`` puts on the card: the "kernel" events of
    a torch.profiler trace (CPU and CUDA activities), counted as
    adamml_tpu_torch/tools/profile_eval_step.py counts them. A later
    session in a process can miss its first kernels (and a trace its
    last), so runs of marker kernels (torch.cuda._sleep's spin_kernel)
    come before and after ``fn``; the trace must begin and end with a
    marker, and ``fn``'s kernels are the others."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        torch.cuda._sleep(10_000_000)
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = [e["name"] for e in sorted(
        (e for e in events if e.get("ph") == "X" and e.get("cat") ==
         "kernel"), key=lambda e: float(e["ts"]))]
    marks = ["spin_kernel" in n for n in names]
    check(bool(marks) and marks[0] and marks[-1],
          f"the profiler trace lost the markers around the profiled call "
          f"({len(names)} kernels)")
    return [n for n, m in zip(names, marks) if not m]


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
    launches = all_counts()
    for row in dw_rows:
        emit("tools", tool="bench_depthwise", **row)
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
    check(launches[tpp.KERNEL] > 0 and launches[dwk.KERNEL] > 0,
          f"the tools launched no kernel: {launches}")
    res["dw_rows"] = dw_rows
    torch.cuda.empty_cache()
    return res


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

        def log_line(logger, msg):
            self.lines.append((time.perf_counter(), msg))
            return log(logger, msg)

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
    torch.cuda.empty_cache()
    return out


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
        emit("real_data", run="train_adamml -e --pretrained", card=card,
             source=os.path.basename(source), seconds=ev["seconds"],
             epochs=[_epoch_line(e) for e in ev["probe"].epochs],
             launches=ev["launches"],
             decoded=_check_decoded("-e --pretrained", ev, argv, decoder),
             grafted_tensors=n, temperature=payload["temperature"],
             max_memory_allocated_bytes=ev["peak"])
    torch.cuda.empty_cache()
    return out


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

    kernels = [tp.KERNEL, tp.KERNEL_BWD, dwk.KERNEL, tpp.KERNEL]
    t0 = time.perf_counter()
    build.build(kernels)
    ptxas = {k: [ln.strip() for ln in build.build_log(k).splitlines()
                 if "Used" in ln or "spill" in ln] for k in kernels}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    one_kernel_phase(dev)
    kres = kernel_phase(dev)
    bres = kernel_bwd_phase(dev)
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
    dres = kernel_dw_phase(dev, sdw["dw_layers"])
    tiny_reference_phase(dev)
    tiny_train_phase(dev)
    tiny_reference_phase(dev, use_pallas_dw=True)
    tiny_train_phase(dev, use_pallas_dw=True)
    ores = tools_phase(dev)
    preprocess_phase(dev)
    cres = cli_phase(dev, smi)
    rres = real_data_phase(dev, smi)

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
                rres["train_adamml_evaluate"][tp.KERNEL]},
        "note": "ms, plain_ms and bound_ms are sums over the three "
                "flagship stage boundaries of one 8-clip eval step; "
                "launches are the serve path's (5 batches)"}, {
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
            "real_data_train_adamml": rres["train_adamml"][tp.KERNEL_BWD]},
        "dab_max_rel_err": bres["dab_max_rel_err"],
        "note": "ms, plain_ms and bound_ms are sums over the three "
                "flagship stage boundaries of one 8-clip main-phase step; "
                "max_abs_err is dy's and dident's; launches are the "
                "main-phase train path's (4 steps)"}, {
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
                "path's (timing runs included)"}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
