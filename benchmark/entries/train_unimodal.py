"""A unimodal train cell: the program's epoch loop
(``train/engine.py::train_epoch``) over its host loader
(``data/dataflow.py::HostDataLoader``), its card preprocessing
(``data/device_pipeline.py::make_unimodal_preprocessor``) and the unimodal
trainer's step (``train/steps.py::make_unimodal_train_step``: eager, one
step a batch), as ``train_unimodal`` runs them for the configuration's
model (SlowFast 8x8 R50, ``benchmark/reference/slowfast.py``).

Set-up makes the data and the weights from the seed, builds the model,
optimizer, loader and step, and runs the first ``check_steps`` steps
through the same loop: one object, handed on to the window. The window is
one more pass of the loop, ended once ``--seconds`` have passed. The
traced stretch runs from step ``skip_steps`` of the window for ``steps``
steps; the profile starts a step before it. Afterwards the program is
freed and the reference follows the first steps from the same weights and
raw data.

The compared numbers are those of ``benchmark/check.py`` over this
model's stages: ``slow.res2``-``slow.res5``, ``fast.res2``-``fast.res5``,
the four lateral connections (``fuse``) as one group and the stems with
the head as one more.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time

import torch

from .. import check, harness
from ..reference import data as ref_data
from ..reference import model as ref_model
from ..reference import slowfast as ref
from ..reference.slowfast_work import step_flops
from ..trace import Profiler, Trace
from .train_epoch import DATASET_LENGTH, Ctx, Feed, HostClock, _floats, sync


def stage_of(name: str) -> str:
    """A leaf's group: a pathway's stage, the lateral connections, or the
    stems and the head."""
    parts = name.split(".")
    if parts[0] in ("slow", "fast") and parts[1].startswith("res"):
        return f"{parts[0]}.{parts[1].split('_')[0]}"
    return "fuse" if parts[0] == "fuse" else "stems_head"


def stage_median(gaps, names) -> float:
    by = {}
    for g, n in zip(gaps, names):
        by.setdefault(stage_of(n), []).append(g)
    return max(statistics.median(v) for v in by.values())


def numbers(prog: dict, ref_res: dict) -> dict:
    """``check.train_numbers`` with this model's stage groups."""
    out = check.train_numbers(prog, ref_res)
    counted = check.counted_leaves(ref_res["grad"])
    out["grad_stage"] = stage_median(
        check.leaf_gaps(prog["grad"], ref_res["grad"]), list(ref_res["grad"]))
    out["update_stage"] = stage_median(
        check.leaf_gaps(prog["update"], ref_res["update"], counted), counted)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t_start):
    from adamml_tpu_torch.configs.config import arg_parser, config_from_args
    from adamml_tpu_torch.data.dataflow import HostDataLoader
    from adamml_tpu_torch.data.device_pipeline import \
        make_unimodal_preprocessor
    from adamml_tpu_torch.models.model_builder import build_model
    from adamml_tpu_torch.train.engine import train_epoch
    from adamml_tpu_torch.train.optim import build_optimizer
    from adamml_tpu_torch.train.steps import make_unimodal_train_step
    from adamml_tpu_torch.train.train_state import TrainState

    tr, conf = cell.traffic, cell.config
    block = conf["reference"]
    spec = ref.Spec.from_dict(block)
    seeds = harness.Seeds.of(seed)
    batch, n_check = tr["batch"], tr["check_steps"]
    cfg = config_from_args(arg_parser().parse_args(conf["flags"]))
    if cfg.optim.batch_size != batch:
        raise SystemExit(f"{cell.name}: the traffic's batch {batch} differs "
                         f"from the configuration's -b "
                         f"{cfg.optim.batch_size}")
    if tr["trace"]["skip_steps"] < 1:
        raise SystemExit(f"{cell.name}: the traced stretch needs a step "
                         "before it (skip_steps >= 1)")
    cfg.data.workers = tr["workers"]

    # -- set-up ------------------------------------------------------------
    pool = harness.source(tr["source"]).make(
        ["rgb"], samples=tr["pool_batches"] * batch, segments=1,
        frames_per_segment=spec.frames, canvas=tuple(block["canvas"]),
        wave_samples=1, num_classes=spec.num_classes, seed=seeds.data,
        device=device)
    specs = ref.param_specs(spec)
    model, _ = build_model(cfg, device)
    model.load_state_dict(ref.make_weights(specs, seeds.weights, device,
                                           block["bn_scale_std"]),
                          strict=True)
    state = TrainState(build_optimizer("main", cfg.optim,
                                       model.parameters()), None)
    step_fn = make_unimodal_train_step(model,
                                       clip_gradient=cfg.optim.clip_gradient)
    pre = make_unimodal_preprocessor(cfg, train=True, num_clips=1,
                                     device=device)
    clock = HostClock()

    def preprocess(host_batch):
        t = time.perf_counter()
        with torch.profiler.record_function("bench.preprocess"):
            out = pre(host_batch)
        clock.preprocess_s += time.perf_counter() - t
        return out

    def step(*args):
        with torch.profiler.record_function("bench.dispatch"):
            return step_fn(*args)

    dataset = harness.source(tr["source"]).Dataset(pool, ["rgb"],
                                                   DATASET_LENGTH)
    loader = HostDataLoader(
        dataset, batch, is_train=True, input_size=cfg.data.input_size,
        augmentor_ver=cfg.data.augmentor_ver,
        scale_range=cfg.data.scale_range,
        disable_scaleup=cfg.data.disable_scaleup, workers=tr["workers"],
        seed=seeds.loader)
    feed = Feed(loader, 1)
    loop = dict(lr=spec.lr, seed=seeds.steps, epoch=0, adamml=False,
                display=1 << 30, rank=0, logger=None)

    # the first gradient as the update takes it: SGD's momentum buffer
    # after its first step
    opt = state.main_opt
    live = list(model.named_parameters())
    first = {}

    def after_first_step(o, args, kwargs):
        if not first:
            for n, p in live:
                first[n] = o.state[p]["momentum_buffer"].norm()

    hook = opt.register_step_post_hook(after_first_step)
    losses = []

    def checked(*args):
        out = step(*args)
        losses.append(out["loss"].reshape(-1))
        return out

    feed.count = n_check
    state, _ = train_epoch(feed, preprocess, checked, state, **loop)
    hook.remove()
    sync(device)

    snap_t0 = time.perf_counter()
    w0 = ref.make_weights(specs, seeds.weights, device, block["bn_scale_std"])
    bufs = dict(model.named_buffers())
    prog = {"loss": torch.cat(losses).tolist(), "grad": _floats(first),
            "update": _floats({n: (p.detach() - w0[n]).norm()
                               for n, p in live}),
            "var": _floats({n: (b - w0[n]).norm() for n, b in bufs.items()
                            if n.endswith("running_var")})}
    del w0, losses
    snap_s = time.perf_counter() - snap_t0

    # -- window ------------------------------------------------------------
    prof = Profiler() if trace else None
    first_traced = tr["trace"]["skip_steps"]
    last_traced = first_traced + tr["trace"]["steps"]
    marks = {first_traced - 1: "start", first_traced: "open",
             last_traced: "close"}

    def on_batch(i):
        if prof is not None and i in marks:
            getattr(prof, marks[i])()

    feed.count, feed.on_batch = None, on_batch
    clock.preprocess_s = 0.0
    clock.begin()
    t0 = time.perf_counter()
    setup_s = t0 - t_start - snap_s
    feed.deadline = t0 + seconds
    state, summary = train_epoch(feed, preprocess, step, state, **loop)
    sync(device)
    window_s = time.perf_counter() - t0
    steps = summary["num_batch"]
    profiler_s = feed.on_batch_s
    data_wait_s = summary["data_time"] * steps - profiler_s
    print("host " + json.dumps(clock.end(
        steps=steps, window_s=window_s, loader_wait_s=data_wait_s,
        profiler_s=profiler_s)), file=sys.stderr)
    events = prof.events() if prof is not None else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    profiled_steps = min(steps, last_traced) - (first_traced - 1)
    stretch_steps = min(steps, last_traced) - first_traced

    # -- the check -----------------------------------------------------------
    feed.close()
    del feed, loader, dataset, step_fn, pre, state, model, opt, live, bufs
    del hook, loop, preprocess, after_first_step, step, checked
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_res = follow(spec, block, pool, batch, n_check, seeds, device)
    nums = numbers(prog, ref_res)
    print("numbers " + json.dumps(nums), file=sys.stderr)
    for key in ("grad", "update"):
        print(f"worst {key} " + json.dumps(check.worst_leaves(
            prog[key], ref_res[key],
            check.counted_leaves(ref_res["grad"]) if key == "update"
            else None)), file=sys.stderr)
    print("losses " + json.dumps([prog["loss"], ref_res["loss"]]),
          file=sys.stderr)
    ok, compared = check.verdict(nums, tr["limits"])

    tr_obj = (Trace(events, profiled_steps, stretch_steps)
              if events is not None else None)
    ctx = Ctx(kind="train", trace=tr_obj, events=events, steps=steps,
              numbers=nums,
              window_s=window_s - profiler_s, data_wait_s=data_wait_s,
              flops_per_step=lambda: step_flops(spec, batch))
    return harness.Outcome(
        end_to_end={"train_clips_per_s": steps * batch / window_s,
                    "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
        ctx=ctx, attempted=steps, failed=0, correct=ok, compared=compared,
        memory_peak_bytes=peak, trace=tr_obj)


def follow(spec, block, pool, batch, steps, seeds, device, *,
           prec: str = "fp32", keep=None, grad_hook=None) -> dict:
    """The reference through the first ``steps`` steps, from the weights
    and raw data made from the seed: per-step loss, the first gradient's
    and the change's leaf norms, the BN running variances' change.
    ``prec``, ``keep`` (the first rows of each batch only) and
    ``grad_hook`` (a leaf's gradient altered) make the control and the
    faults (benchmark/tools/control_unimodal.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w0 = ref.make_weights(ref.param_specs(spec), seeds.weights, device,
                          block["bn_scale_std"])
    trainer = ref.Trainer(spec, w0, prec=ref_model.Prec(prec),
                          ckpt=device.type == "cuda")
    batches = ref_data.train_batches(
        pool, ["rgb"], batch, steps, DATASET_LENGTH, seeds.loader,
        spec.input_size, block["scale_range"])
    losses, grad = [], None
    for s, b in enumerate(batches):
        idx = b["index"][:keep]
        x = ref_data.inputs(pool, ["rgb"], idx,
                            {"rgb": tuple(a[:keep] for a in b["rgb"])}, 1,
                            spec.frames, spec.input_size, 1, 1.0,
                            device)["rgb"][:, 0]
        target = torch.from_numpy(pool.labels[idx]).to(device)
        _, drop = ref_model.noise(device, seeds.steps, s)
        loss, taken = trainer.step(x, target, drop, grad_hook)
        losses.append(loss)
        if grad is None:
            grad = _floats({n: g.norm() for n, g in taken.items()})
        del x, taken
    return {"loss": losses, "grad": grad,
            "update": _floats({n: (trainer.params[n] - w0[n]).norm()
                               for n in trainer.live}),
            "var": _floats({n: (v - w0[n]).norm()
                            for n, v in trainer.stats.items()
                            if n.endswith("running_var")})}
