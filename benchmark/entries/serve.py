"""A serve cell: one caller in a closed loop. A request is one host batch
of clips (``batch`` clips of ``segments`` segments, made by the program's
eval loader from the source's raw samples at set-up); it goes through the
program's card preprocessing (``make_batch_preprocessor(train=False)``)
and eval step (``train/steps.py::make_adamml_eval_step``) and ends when
its logits and decisions are on the host. Its latency runs from hand-in to
that moment. Request i draws its Gumbel noise from seed
step_seed(run seed, i), as the program's validation does a batch.

After the window a sample of the window's requests, drawn from the seed,
is worked out again by the reference from the raw samples and the same
noise, and compared.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

from .. import check, harness
from ..reference import data as ref_data
from ..reference import model as ref
from ..reference import work
from ..trace import Profiler, Trace
from .train_epoch import Ctx, HostClock, sync


def run(cell, seed: int, seconds: float, trace: bool, device, t_start):
    from adamml_tpu_torch.configs.config import arg_parser, config_from_args
    from adamml_tpu_torch.data.dataflow import HostDataLoader
    from adamml_tpu_torch.data.device_pipeline import make_batch_preprocessor
    from adamml_tpu_torch.models.model_builder import build_model
    from adamml_tpu_torch.train.steps import make_adamml_eval_step
    from adamml_tpu_torch.train.train_state import EvalState

    tr, conf = cell.traffic, cell.config
    spec = ref.Spec.from_dict(conf["reference"])
    seeds = harness.Seeds.of(seed)
    batch, segments = tr["batch"], tr["segments"]
    modality = list(spec.modality)
    cfg = config_from_args(arg_parser().parse_args(conf["flags"]))
    cfg.data.val_num_clips = segments
    cfg.data.workers = tr["workers"]
    if tr["trace"]["skip_requests"] < 1:
        raise SystemExit(f"{cell.name}: the traced stretch needs a request "
                         "before it (skip_requests >= 1)")

    # -- set-up ------------------------------------------------------------
    src = harness.source(tr["source"])
    pool = src.make(
        modality, samples=tr["pool_batches"] * batch, segments=segments,
        frames_per_segment=spec.frames, canvas=spec.canvas,
        wave_samples=round(spec.resampling_rate * spec.audio_length),
        num_classes=spec.num_classes, seed=seeds.data, device=device)
    model, _ = build_model(cfg, device)
    model.load_state_dict(ref.make_weights(ref.param_specs(spec),
                                           seeds.weights, device),
                          strict=True)
    model.eval()
    eval_step = make_adamml_eval_step(model, num_crops=1)
    pre = make_batch_preprocessor(cfg, train=False, num_segments=segments,
                                  device=device)
    loader = HostDataLoader(
        src.Dataset(pool, modality, pool.size), batch, is_train=False,
        input_size=cfg.data.input_size, workers=tr["workers"],
        seed=seeds.loader)
    host_batches = list(loader)
    state = EvalState(temperature=spec.temperature)

    phases = {"preprocess": [], "eval_step": [], "readback": []}

    def request(i):
        hb = host_batches[i % len(host_batches)]
        t = [time.perf_counter()]
        with torch.profiler.record_function("bench.preprocess"):
            inputs, target = pre(hb)
        t.append(time.perf_counter())
        with torch.profiler.record_function("bench.eval_step"):
            logits, decisions, _ = eval_step(
                state, inputs, target, ref.step_seed(seeds.steps, i))
        t.append(time.perf_counter())
        out = logits.cpu().numpy(), decisions.cpu().numpy()
        t.append(time.perf_counter())
        for name, a, b in zip(phases, t, t[1:]):
            phases[name].append(b - a)
        return out

    for i in range(tr["warmup_requests"]):
        request(i)
    sync(device)

    # -- window ------------------------------------------------------------
    # traced: the profile starts one request before the stretch, which
    # runs from request first_traced to request last_traced
    prof = Profiler() if trace else None
    traced = tr["trace"]
    first_traced = traced["skip_requests"]
    last_traced = first_traced + traced["requests"]
    marks = {first_traced - 1: "start", first_traced: "open",
             last_traced: "close"}
    lat, outs = [], []
    for v in phases.values():
        v.clear()
    clock, collector = HostClock(), Collector()
    clock.begin()
    gc.callbacks.append(collector)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    i = 0
    while time.perf_counter() < deadline:
        if prof is not None and i in marks:
            getattr(prof, marks[i])()
        s = time.perf_counter()
        outs.append(request(tr["warmup_requests"] + i))
        lat.append(time.perf_counter() - s)
        i += 1
    window_s = time.perf_counter() - t0
    gc.callbacks.remove(collector)
    clock.preprocess_s = sum(phases["preprocess"])
    print("host " + json.dumps(clock.end(
        requests=i, window_s=window_s, latency_ms=_quantiles(lat),
        gc_n=collector.n, gc_s=collector.s,
        **{f"{k}_ms": _quantiles(v) for k, v in phases.items()})),
        file=sys.stderr)
    events = prof.events() if prof is not None else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # -- the check -----------------------------------------------------------
    del loader, host_batches, model, eval_step, pre, request
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(seeds.check)
    picked = sorted(rng.choice(i, size=min(i, tr["check_requests"]),
                               replace=False).tolist())
    mine = [outs[j] for j in picked]
    theirs = answer(spec, pool, batch, segments,
                    [tr["warmup_requests"] + j for j in picked], seeds,
                    device)
    numbers = check.serve_numbers(mine, theirs)
    print("numbers " + json.dumps(numbers), file=sys.stderr)
    ok, compared = check.verdict(numbers, tr["limits"])

    tr_obj = (Trace(events, min(i, last_traced) - (first_traced - 1),
                    min(i, last_traced) - first_traced)
              if events is not None else None)
    profiled = range(first_traced - 1, last_traced) if trace else ()
    ctx = Ctx(kind="serve", trace=tr_obj, requests=i, window_s=window_s,
              latency_s=[t for j, t in enumerate(lat) if j not in profiled],
              flops_per_request=lambda: work.step_flops(spec, "eval", batch,
                                                        segments),
              epilogue=work.epilogue_bound_ms(spec, batch * segments,
                                              backward=False))
    return harness.Outcome(
        end_to_end={"serve_clips_per_s": i * batch / window_s,
                    "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
        ctx=ctx, attempted=i, failed=0, correct=ok, compared=compared,
        memory_peak_bytes=peak, trace=tr_obj)


class Collector:
    """The garbage collector's passes and seconds, as a ``gc.callbacks``
    entry."""

    def __init__(self):
        self.n, self.s, self._t = 0, 0.0, 0.0

    def __call__(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.n += 1
            self.s += time.perf_counter() - self._t


def _quantiles(seconds):
    """The median, 95th percentile and largest of host times, in ms, and
    their sum in s."""
    ms = np.asarray(seconds) * 1e3
    return {"p50": float(np.percentile(ms, 50)),
            "p95": float(np.percentile(ms, 95)),
            "max": float(ms.max()), "sum_s": float(ms.sum()) / 1e3}


@torch.no_grad()
def answer(spec, pool, batch, segments, requests, seeds, device,
           prec: str = "fp32"):
    """The reference's (logits, decisions) of each request (``prec``
    "fp8": the control, benchmark/tools/control.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = ref.make_weights(ref.param_specs(spec), seeds.weights, device)
    params = {k: v for k, v in w.items() if not ref.is_statistic(k)}
    stats = {k: v for k, v in w.items() if ref.is_statistic(k)}
    visual = [m for m in spec.modality if m != "sound"]
    n_batches = pool.size // batch
    out = []
    for r in requests:
        idx = np.arange(batch) + (r % n_batches) * batch
        crops = {m: (ref_data.center_crops(pool.hw[idx], spec.input_size),
                     np.zeros(batch, bool)) for m in visual}
        x = ref_data.inputs(pool, list(spec.modality), idx, crops, segments,
                            spec.frames, spec.input_size,
                            spec.resampling_rate, spec.audio_length, device)
        gumbel, _ = ref.noise(device, ref.step_seed(seeds.steps, r), 0)
        logits, decisions, _ = ref.forward(params, stats, spec, x,
                                           train=False, gumbel=gumbel,
                                           prec=ref.Prec(prec))
        out.append((logits.cpu().numpy(), decisions.cpu().numpy()))
    return out
