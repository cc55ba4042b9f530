#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adamml_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device      card name, count, and nvidia-smi's name and power limit;
  build       nvcc builds every CUDA kernel from csrc/ (one process per
              source, all at once) and prints ptxas' registers, shared
              memory, spills;
  kernel      the forward kernel against its plain PyTorch version, at the
              flagship eval shapes and at grouped, float32 and odd-F cases,
              with CUDA-event times beside the bound;
  kernel_bwd  the backward kernel against its plain version, at the three
              flagship train shapes (R = 1, S = 5), float32, odd F, R = 2
              and an engineered tie, with the same timings;
  serve       the flagship AdaMML eval step at full width (ResNet-50 +
              MobileNetV2 audio, rgb + sound, 5 segments x 8 frames,
              224x224, LSTM policy, learnable late fusion, bf16, 31
              classes), seeded random weights, 4 requests of 8 clips after
              one warm-up; launch counts zeroed just before and read just
              after; outputs checked against the plain composition
              (fused_tpool=False) and, at the tiny float32 config, against
              the same model on the CPU;
  train       the flagship train step at full width, main phase (SGD on the
              main net) then policy phase (Adam on the policy net), 8 clips
              a step, 1 warm-up and 3 timed steps each; launch counts zeroed
              just before each phase and read just after; checks on losses,
              decisions, which parameters and statistics moved;
  train_vs_plain  one main-phase step with fused_tpool=False on the same
              weights and batch: loss and updates against the fused step;
  tiny_train  one float32 step of each phase on the card against the CPU;
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
import subprocess
import sys
import time

import torch

from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.models.model_builder import build_model, example_inputs
from adamml_tpu_torch.ops.augment import policy_stream
from adamml_tpu_torch.ops.kernels import build
from adamml_tpu_torch.ops.kernels import tpool_fused as tp
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.steps import (make_adamml_eval_step,
                                          make_adamml_train_step)
from adamml_tpu_torch.train.train_state import (EvalState, StageFlags,
                                                TrainState)

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, float32 outside the tensor
# cores; the bound of a kernel is the larger of bytes/rate and ops/rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_FLUSH_BYTES = 256 << 20
# the train step's settings (bench.py:156-161)
LR, P_LR, COST, GAMMAS = 1e-3, 1e-2, [1.0, 0.05], 10.0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` runs after ``warmup``;
    ``flush`` (a buffer zeroed between runs, outside the timed span) evicts
    the L2 cache so every run reads its inputs from device memory. A spin
    of about 60 ms queued first keeps the card busy while the host queues
    every run, so no host gap between the events is counted as device
    time."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)
    for start, end in pairs:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


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


def within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> bool:
    g, w = got.float(), want.float()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      torch.ldexp(torch.ones_like(w), e - 8))
    return bool(((g - w).abs() <= ulp).all())


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
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
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
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
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


def serve_phase(dev, card: str) -> dict:
    cfg = flagship_cfg()
    batch, s = 8, cfg.model.num_segments
    num_classes = cfg.model.num_classes
    model, name = build_model(cfg)
    step = make_adamml_eval_step(model)
    state = EvalState()
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [(example_inputs(cfg, batch=batch, seed=100 + k),
                torch.randint(0, num_classes, (batch,), generator=gen,
                              device=dev)) for k in range(5)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: counts zeroed just before, read just after
    for k in tp.launch_counts:
        tp.launch_counts[k] = 0
    latencies, first = [], None
    for i, (inputs, target) in enumerate(batches):
        before = tp.launch_counts[tp.KERNEL]
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
        check(tp.launch_counts[tp.KERNEL] - before == 3,
              f"batch {i}: {tp.launch_counts[tp.KERNEL] - before} kernel "
              "launches, expected 3 (stage boundaries 1-3)")
        if i == 0:
            first = (logits, decisions)
        else:  # batch 0 is the warm-up
            latencies.append(dt)
    launches = dict(tp.launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    emit("serve", arch=name, card=card, batch_clips=batch,
         requests=len(latencies), warmup=1,
         latency_ms=[x * 1e3 for x in latencies],
         clips_per_s=[batch / x for x in latencies],
         max_memory_allocated_bytes=peak, launches=launches,
         selection_rate=float(first[1].mean()),
         timing="host clock around each step, ending in "
                "torch.cuda.synchronize()")

    # the same batch and weights through the plain composition
    cfg_plain = flagship_cfg()
    cfg_plain.model.fused_tpool = False
    plain, _ = build_model(cfg_plain)
    plain.load_state_dict(model.state_dict())
    p_logits, p_dec, _ = make_adamml_eval_step(plain)(
        state, batches[0][0], batches[0][1], seed=0)
    torch.cuda.synchronize()
    check(launches == tp.launch_counts, "the plain composition launched the "
          "fused kernel")
    scale = float(first[0].abs().max())
    diff = float((p_logits - first[0]).abs().max())
    # each stage boundary rounds to bf16 once in the kernel and twice in the
    # composition (after the BN apply and after the add): up to 1 bf16 ulp
    # (2^-8 relative) apart, which the later layers carry to the logits;
    # 2% of the largest logit (about 5 ulps) bounds it
    tol = 0.02 * max(scale, 1.0)
    check(torch.equal(p_dec, first[1]), "decisions differ from the plain "
          "composition")
    check(diff <= tol, f"logits differ from the plain composition by {diff} "
          f"> {tol}")
    emit("serve_vs_plain", max_abs_logit=scale, max_abs_diff=diff,
         tolerance=tol, decisions_equal=True)
    del plain, model, step, batches
    torch.cuda.empty_cache()
    return {"launches": launches[tp.KERNEL]}


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


def train_phase(dev, card: str) -> dict:
    """The flagship train step at full width: the main phase, then the
    policy phase, on one model and state, as the alternating curriculum
    runs them."""
    cfg = flagship_cfg()
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
        start = _snapshot(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # this path: counts zeroed just before, read just after
        for k in tp.launch_counts:
            tp.launch_counts[k] = 0
        latencies, losses = [], []
        for i, (inputs, target) in enumerate(batches):
            before = dict(tp.launch_counts)
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
                  f"kernel launches, expected 3 and {want_bwd}")
            check(set(seen[-1].unique().tolist()) <= {0.0, 1.0},
                  f"{phase} step {i}: decisions outside {{0, 1}}")
            losses.append(vals)
            if i:  # step 0 is the warm-up
                latencies.append(dt)
        launches = dict(tp.launch_counts)
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
        emit("train", curriculum_phase=phase, arch=name, card=card,
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


def tiny_train_phase(dev) -> None:
    """One float32 step of each phase from the same weights, on the card
    and on the CPU: 8 clips at 64x64 (at fewer samples per BN group the
    tiny model's gradient is ill-conditioned), dropout 0, zero-noise
    decisions, TF32 off. Losses within 1e-3 relative; SGD updates each
    within 0.1 * lr; 99% of the Adam updates within 0.1 * p_lr (Adam maps
    each gradient element to about +-p_lr, so elements within float32
    noise of 0 may take either sign)."""
    cfg = flagship_cfg(tiny=True)
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
                m = _make_step(model, phase)(
                    _train_state(model, cfg), [a.to(d) for a in x],
                    target.to(d), LR, P_LR, COST, seed=0)
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
    emit("tiny_train", **line)


def tiny_reference_phase(dev) -> None:
    """Tiny float32 config: the policy logits and the decision-masked main
    net on the card against the same weights on the CPU."""
    cfg = flagship_cfg(tiny=True)
    gpu, _ = build_model(cfg)
    cpu, _ = build_model(cfg, device="cpu")
    x_cpu = example_inputs(cfg, batch=4, device="cpu", seed=3)
    n, s = x_cpu[0].shape[:2]
    size = cfg.model.policy_input_size
    dec = (torch.arange(2 * n * s) % 3 != 0).float().reshape(2, n * s)
    outs = []
    for model, x, d in ((gpu, [a.to(dev) for a in x_cpu], dec.to(dev)),
                        (cpu, x_cpu, dec)):
        with torch.no_grad():
            _, p_logits = model.policy_net(
                [policy_stream(x[0], size), x[1]], 5.0)
            m_logits = model.main_net(
                [a.reshape((n * s,) + tuple(a.shape[2:])) for a in x], d,
                seq_groups=s)
        outs.append((p_logits.cpu(), m_logits.cpu()))
    errs = [float((g - c).abs().max()) for g, c in zip(*outs)]
    # float32 with TF32 off: cuDNN and the CPU sum in other orders
    check(max(errs) <= 1e-3, f"card vs CPU at the tiny config: {errs}")
    emit("tiny_reference", policy_logits_err=errs[0],
         main_logits_err=errs[1], tolerance=1e-3)


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

    kernels = [tp.KERNEL, tp.KERNEL_BWD]
    t0 = time.perf_counter()
    build.build(kernels)
    ptxas = {k: [ln.strip() for ln in build.build_log(k).splitlines()
                 if "Used" in ln or "spill" in ln] for k in kernels}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    kres = kernel_phase(dev)
    bres = kernel_bwd_phase(dev)
    sres = serve_phase(dev, smi)
    tres = train_phase(dev, smi)
    train_vs_plain_phase(dev)
    tiny_reference_phase(dev)
    tiny_train_phase(dev)

    print(json.dumps({"kernels": [{
        "name": tp.KERNEL, "route": "cuda",
        "source": "adamml_tpu_torch/csrc/tpool_fused.cu",
        "replaces": "adamml_tpu/ops/pallas/tpool_fused.py:71",
        "also_replaces": ["adamml_tpu/ops/pallas/tpool_fused.py:345"],
        "launches": sres["launches"], "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"], "plain_ms": kres["plain_ms"],
        "bound_ms": kres["bound_ms"],
        "bound_by": ("bytes" if kres["bytes_s"] >= kres["ops_s"]
                     else "operations"),
        "library_ms": None,
        "launches_by_path": {"serve": sres["launches"],
                             "train_main": tres["main"][tp.KERNEL],
                             "train_policy": tres["policy"][tp.KERNEL]},
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
        "bound_ms": bres["bound_ms"],
        "bound_by": ("bytes" if bres["bytes_s"] >= bres["ops_s"]
                     else "operations"),
        "library_ms": None,
        "launches_by_path": {"train_main": tres["main"][tp.KERNEL_BWD],
                             "train_policy": tres["policy"][tp.KERNEL_BWD]},
        "dab_max_rel_err": bres["dab_max_rel_err"],
        "note": "ms, plain_ms and bound_ms are sums over the three "
                "flagship stage boundaries of one 8-clip main-phase step; "
                "max_abs_err is dy's and dident's; launches are the "
                "main-phase train path's (4 steps)"}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
