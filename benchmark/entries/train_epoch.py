"""A train cell: the program's epoch loop (``train/engine.py::train_epoch``)
over its host loader (``data/dataflow.py::HostDataLoader``), its card
preprocessing (``data/device_pipeline.py::make_batch_preprocessor``) and
its K-step dispatch (``train/steps.py::make_adamml_multi_step``: on the
card one CUDA graph of K steps, replayed), as ``--steps_per_dispatch K``
runs it.

Set-up makes the data and the weights from the seed, builds the model,
optimizers, loader and steps, and runs the first ``check_steps`` steps
through the same loop (the eager first dispatch, then the capture and its
first replay): one object, handed on to the window. The window is one more
pass of the loop, ended at a dispatch boundary once ``--seconds`` have
passed, with every dispatch a replay. Afterwards the program is freed and
the reference follows the first steps from the same weights and raw data.
"""

from __future__ import annotations

import gc
import json
import resource
import sys
import time

import torch

from .. import check, harness
from ..reference import data as ref_data
from ..reference import model as ref
from ..reference import work
from ..trace import Profiler, Trace

# long enough that an epoch outlasts any window
DATASET_LENGTH = 1_000_000


class Feed:
    """The loader as the epoch loop sees it: one iterator over epoch 0,
    kept from the warm-up into the window. A pass ends after ``count``
    batches, or at a dispatch boundary once the clock passes
    ``deadline``; ``on_batch(i)`` runs before batch i of a pass is taken,
    and its host time, which the loop counts as waiting for data, is
    summed in ``on_batch_s``."""

    def __init__(self, loader, k: int):
        self.loader, self.k = loader, k
        self.it = iter(loader)
        self.count = self.deadline = self.on_batch = None
        self.on_batch_s = 0.0

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return DATASET_LENGTH // self.loader.batch_size

    def __iter__(self):
        i = 0
        while True:
            if self.count is not None and i >= self.count:
                return
            if (self.deadline is not None and i % self.k == 0
                    and time.perf_counter() >= self.deadline):
                return
            if self.on_batch is not None:
                t = time.perf_counter()
                self.on_batch(i)
                self.on_batch_s += time.perf_counter() - t
            with torch.profiler.record_function("bench.loader"):
                batch = next(self.it)
            i += 1
            yield batch

    def close(self) -> None:
        self.it.close()


class Dispatch:
    """The K-step call, in a span of its own, its metrics kept while
    ``record`` is a list, its host time summed in ``host_s``."""

    def __init__(self, multi):
        self.multi, self.record = multi, None
        self.host_s = 0.0

    def __call__(self, *args):
        t = time.perf_counter()
        with torch.profiler.record_function("bench.dispatch"):
            out = self.multi(*args)
        self.host_s += time.perf_counter() - t
        if self.record is not None:
            self.record.append(out)
        return out


class HostClock:
    """The host's share of the window, printed with every run on standard
    error (``host``): the main thread's seconds in the preprocessing call
    and in the dispatch call, and the process's CPU seconds."""

    def __init__(self):
        self.preprocess_s = 0.0

    def begin(self) -> None:
        self.r0 = resource.getrusage(resource.RUSAGE_SELF)

    def end(self, **kw) -> dict:
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        return dict(kw, preprocess_s=self.preprocess_s,
                    user_s=r1.ru_utime - self.r0.ru_utime,
                    sys_s=r1.ru_stime - self.r0.ru_stime)


class Ctx:
    """What the per-layer readers of a train cell read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _floats(d):
    keys = list(d)
    vals = torch.stack([d[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start):
    from adamml_tpu_torch.configs.config import arg_parser, config_from_args
    from adamml_tpu_torch.data.dataflow import HostDataLoader
    from adamml_tpu_torch.data.device_pipeline import make_batch_preprocessor
    from adamml_tpu_torch.models.model_builder import build_model
    from adamml_tpu_torch.train.engine import train_epoch
    from adamml_tpu_torch.train.optim import build_optimizer
    from adamml_tpu_torch.train.steps import (make_adamml_multi_step,
                                              make_adamml_train_step)
    from adamml_tpu_torch.train.train_state import StageFlags, TrainState

    tr, conf = cell.traffic, cell.config
    spec = ref.Spec.from_dict(conf["reference"])
    seeds = harness.Seeds.of(seed)
    phase, batch, k = tr["phase"], tr["batch"], tr["steps_per_dispatch"]
    segments, n_check = spec.segments, tr["check_steps"]
    modality = list(spec.modality)
    cost = ([0.0] * len(spec.main_modality) if phase == "main"
            else list(spec.cost_weights))
    cfg = config_from_args(arg_parser().parse_args(conf["flags"]))
    if (cfg.optim.batch_size, cfg.optim.steps_per_dispatch) != (batch, k):
        raise SystemExit(
            f"{cell.name}: the traffic's batch {batch} and K {k} differ from "
            f"the configuration's -b {cfg.optim.batch_size} and "
            f"--steps_per_dispatch {cfg.optim.steps_per_dispatch}")
    if tr["trace"]["skip_dispatches"] < 1:
        raise SystemExit(f"{cell.name}: the traced stretch needs a "
                         "dispatch before it (skip_dispatches >= 1)")
    cfg.data.workers = tr["workers"]

    # -- set-up ------------------------------------------------------------
    pool = harness.source(tr["source"]).make(
        modality, samples=tr["pool_batches"] * batch, segments=segments,
        frames_per_segment=spec.frames, canvas=spec.canvas,
        wave_samples=round(spec.resampling_rate * spec.audio_length),
        num_classes=spec.num_classes, seed=seeds.data, device=device)
    specs = ref.param_specs(spec)
    model, _ = build_model(cfg, device)
    model.load_state_dict(ref.make_weights(specs, seeds.weights, device),
                          strict=True)
    state = TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()),
        temperature=spec.temperature)
    flags = (StageFlags.main_phase() if phase == "main"
             else StageFlags.policy_phase())
    common = dict(flags=flags, penalty_type=cfg.model.penalty_type,
                  gammas=cfg.model.gammas,
                  clip_gradient=cfg.optim.clip_gradient)
    step_fn = make_adamml_train_step(model, **common)
    multi = make_adamml_multi_step(model, **common)
    dispatch = Dispatch(multi)
    pre = make_batch_preprocessor(cfg, train=True, num_segments=segments,
                                  device=device)

    clock = HostClock()

    def preprocess(host_batch):
        t = time.perf_counter()
        with torch.profiler.record_function("bench.preprocess"):
            out = pre(host_batch)
        clock.preprocess_s += time.perf_counter() - t
        return out

    dataset = harness.source(tr["source"]).Dataset(pool, modality,
                                                   DATASET_LENGTH)
    loader = HostDataLoader(
        dataset, batch, is_train=True, input_size=cfg.data.input_size,
        augmentor_ver=cfg.data.augmentor_ver,
        scale_range=cfg.data.scale_range,
        disable_scaleup=cfg.data.disable_scaleup, workers=tr["workers"],
        seed=seeds.loader)
    feed = Feed(loader, k)
    loop = dict(lr=spec.lr, p_lr=spec.p_lr, cost_weights=cost,
                seed=seeds.steps, epoch=0,
                modality=list(cfg.model.major_modality), adamml=True,
                display=1 << 30, rank=0, logger=None,
                multi_step_fn=dispatch, steps_per_dispatch=k)

    # the first gradient as the update takes it, from the optimizer's
    # state after its first step
    opt = state.main_opt if phase == "main" else state.policy_opt
    live = [(n, p) for n, p in model.named_parameters()
            if n.startswith(f"{phase}_net.")]
    first = {}

    def after_first_step(o, args, kwargs):
        if first:
            return
        for n, p in live:
            st = o.state[p]
            first[n] = (st["momentum_buffer"] if phase == "main"
                        else st["exp_avg"] / (1 - ref.ADAM_BETAS[0])).norm()

    hook = opt.register_step_post_hook(after_first_step)
    dispatch.record = []
    feed.count = n_check
    state, _ = train_epoch(feed, preprocess, step_fn, state, **loop)
    hook.remove()
    sync(device)

    snap_t0 = time.perf_counter()
    w0 = ref.make_weights(specs, seeds.weights, device)
    params, bufs = dict(model.named_parameters()), dict(model.named_buffers())
    prog = {"loss": torch.cat([d["loss"].reshape(-1) for d in dispatch.record]
                              ).tolist(),
            "grad": _floats(first),
            "update": _floats({n: (p.detach() - w0[n]).norm()
                               for n, p in live}),
            "var": _floats({n: (b - w0[n]).norm() for n, b in bufs.items()
                            if n.endswith("running_var")})}
    del w0
    dispatch.record = None
    eager = getattr(multi, "eager_dispatches", None)
    replays = getattr(multi, "replays", 0)
    snap_s = time.perf_counter() - snap_t0

    # -- window ------------------------------------------------------------
    # traced: the profile starts one dispatch before the stretch, which
    # runs from batch first_traced to batch last_traced
    prof = Profiler() if trace else None
    traced = tr["trace"]
    first_traced = traced["skip_dispatches"] * k
    last_traced = first_traced + traced["dispatches"] * k
    marks = {first_traced - k: "start", first_traced: "open",
             last_traced: "close"}

    def on_batch(i):
        if prof is not None and i in marks:
            getattr(prof, marks[i])()

    feed.count, feed.on_batch = None, on_batch
    dispatch.host_s = clock.preprocess_s = 0.0
    clock.begin()
    t0 = time.perf_counter()
    setup_s = t0 - t_start - snap_s
    feed.deadline = t0 + seconds
    state, summary = train_epoch(feed, preprocess, step_fn, state, **loop)
    sync(device)
    window_s = time.perf_counter() - t0
    steps = summary["num_batch"]
    profiler_s = feed.on_batch_s
    data_wait_s = summary["data_time"] * steps - profiler_s
    print("host " + json.dumps(clock.end(
        steps=steps, window_s=window_s, loader_wait_s=data_wait_s,
        dispatch_s=dispatch.host_s, profiler_s=profiler_s)),
        file=sys.stderr)
    events = prof.events() if prof is not None else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if eager is not None and (multi.eager_dispatches != eager
                              or multi.replays - replays != steps // k):
        raise RuntimeError(
            f"the window ran {multi.eager_dispatches - eager} eager "
            f"dispatches and {multi.replays - replays} replays for "
            f"{steps} steps; it must run only replays")
    profiled_steps = min(steps, last_traced) - (first_traced - k)
    stretch_steps = min(steps, last_traced) - first_traced

    # -- the check -----------------------------------------------------------
    feed.close()
    del feed, loader, dataset, dispatch, multi, step_fn, pre, state, model
    del opt, live, params, bufs, hook, loop, preprocess, after_first_step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_res = follow(spec, pool, phase, batch, n_check, seeds, device, cost)
    numbers = check.train_numbers(prog, ref_res)
    print("numbers " + json.dumps(numbers), file=sys.stderr)
    for key in ("grad", "update"):
        print(f"worst {key} " + json.dumps(check.worst_leaves(
            prog[key], ref_res[key],
            check.counted_leaves(ref_res["grad"]) if key == "update"
            else None)), file=sys.stderr)
    print("losses " + json.dumps([prog["loss"], ref_res["loss"]]),
          file=sys.stderr)
    ok, compared = check.verdict(numbers, tr["limits"])

    tr_obj = (Trace(events, profiled_steps, stretch_steps)
              if events is not None else None)
    ctx = Ctx(kind="train", trace=tr_obj, steps=steps,
              window_s=window_s - profiler_s, data_wait_s=data_wait_s,
              flops_per_step=lambda: work.step_flops(spec, phase, batch,
                                                     segments),
              epilogue=work.epilogue_bound_ms(spec, batch * segments,
                                              backward=phase == "main"))
    clips = steps * batch
    return harness.Outcome(
        end_to_end={"train_clips_per_s": clips / window_s,
                    "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
        ctx=ctx, attempted=steps, failed=0, correct=ok, compared=compared,
        memory_peak_bytes=peak, trace=tr_obj)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def follow(spec, pool, phase, batch, steps, seeds, device, cost, *,
           prec: str = "fp32", keep=None) -> dict:
    """The reference through the first ``steps`` steps, from the weights
    and raw data made from the seed: per-step loss, the first gradient's
    and the change's leaf norms, the BN running variances' change.
    ``prec`` and ``keep`` (the first rows of each batch only) make the
    control and a fault (benchmark/tools/control.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w0 = ref.make_weights(ref.param_specs(spec), seeds.weights, device)
    trainer = ref.Trainer(spec, w0, phase, prec=ref.Prec(prec),
                          ckpt=device.type == "cuda")
    visual = [m for m in spec.modality if m != "sound"]
    batches = ref_data.train_batches(
        pool, visual, batch, steps, DATASET_LENGTH, seeds.loader,
        spec.input_size, spec.scale_range)
    losses, grad = [], None
    for s, b in enumerate(batches):
        idx = b["index"][:keep]
        x = ref_data.inputs(pool, list(spec.modality), idx,
                            {m: tuple(a[:keep] for a in b[m])
                             for m in visual}, spec.segments,
                            spec.frames, spec.input_size,
                            spec.resampling_rate, spec.audio_length, device)
        target = torch.from_numpy(pool.labels[idx]).to(device)
        gumbel, drop = ref.noise(device, seeds.steps, s)
        loss, taken = trainer.step(x, target, gumbel, drop, cost)
        losses.append(loss)
        if grad is None:
            grad = _floats({n: g.norm() for n, g in taken.items()})
        del x, taken
    out = {"loss": losses, "grad": grad,
           "update": _floats({n: (trainer.params[n] - w0[n]).norm()
                              for n in trainer.live}),
           "var": _floats({n: (v - w0[n]).norm()
                           for n, v in trainer.stats.items()
                           if n.endswith("running_var")})}
    return out
