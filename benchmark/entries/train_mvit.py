"""The MViTv2 train cell: the program's epoch loop
(``train/engine.py::train_epoch``) over its host loader
(``data/dataflow.py::HostDataLoader``, random-sized crops), its card
preprocessing (``data/device_pipeline.py::make_unimodal_preprocessor``)
and the unimodal trainer's step (``train/steps.py::make_unimodal_train_step``:
eager, one step a batch, the global-norm clip, AdamW), as
``train_unimodal --backbone_net mvit --optimizer adamw`` runs them
(MViTv2-S 16x4, ``benchmark/reference/mvit.py``).

Set-up makes the data and the weights from the seed, builds the model,
optimizer, loader and step, and runs the first ``check_steps`` steps
through the same loop: one object, handed on to the window. The window is
one more pass of the loop, ended once ``--seconds`` have passed. The
traced stretch runs from step ``skip_steps`` of the window for ``steps``
steps; the profile starts a step before it. Afterwards the program is
freed and the reference follows the first steps from the same weights,
raw clips, crops and drop masks.

The compared numbers (``numbers``): the gaps of norms of
``benchmark/check.py`` over this model's leaves and stage groups
(``stage_of``): the first gradient as the update takes it (AdamW's first
moment after step 1 over 0.1: the clipped gradient), the second step's
gradient recovered from the first moments after steps 1 and 2, and each
parameter's change after the checked steps.
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
from ..reference import mvit as ref
from ..reference.mvit_work import attn_least_ms, step_flops
from ..trace import Profiler, Trace
from .train_epoch import DATASET_LENGTH, Ctx, Feed, HostClock, _floats, sync

B1 = ref.BETAS[0]
TRANSITIONS = ref.Spec().transitions


def stage_of(name: str) -> str:
    """A leaf's group: the patch embedding, a stage's blocks (s1: block 0,
    s2: 1-2, s3: 3-13, s4: 14-15 at the published depth), or the head
    with the final LayerNorm and the cls token."""
    parts = name.split(".")
    if parts[0] == "patch_embed":
        return "patch"
    if parts[0] != "blocks":
        return "head"
    return f"s{1 + sum(int(parts[1]) >= t for t in TRANSITIONS)}"


def stage_median(gaps, names) -> float:
    by = {}
    for g, n in zip(gaps, names):
        by.setdefault(stage_of(n), []).append(g)
    return max(statistics.median(v) for v in by.values())


def numbers(prog: dict, ref_res: dict) -> dict:
    """prog, ref_res: {"loss": [per step], "grad", "grad2": {leaf: norm of
    the first and second steps' gradients as the update takes them},
    "update": {leaf: norm of the change after the checked steps}}."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                  ref_res["loss"])]
    counted = check.counted_leaves(ref_res["grad"])
    names = list(ref_res["grad"])
    out = {"loss": max(losses), "loss_step1": losses[0]}
    for key in ("grad", "grad2"):
        gaps = check.leaf_gaps(prog[key], ref_res[key])
        out[f"{key}_median"] = statistics.median(gaps)
        out[f"{key}_stage"] = stage_median(gaps, names)
    upd = check.leaf_gaps(prog["update"], ref_res["update"], counted)
    out.update(update_median=statistics.median(upd),
               update_stage=stage_median(upd, counted),
               leaves_left_out=float(len(names) - len(counted)))
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
    if tr["trace"]["skip_steps"] < 1 or n_check < 2:
        raise SystemExit(f"{cell.name}: the traced stretch needs a step "
                         "before it (skip_steps >= 1) and the check two "
                         "steps (check_steps >= 2)")
    cfg.data.workers = tr["workers"]

    # -- set-up ------------------------------------------------------------
    pool = harness.source(tr["source"]).make(
        ["rgb"], samples=tr["pool_batches"] * batch, segments=1,
        frames_per_segment=spec.frames, canvas=tuple(block["canvas"]),
        wave_samples=1, num_classes=spec.num_classes, seed=seeds.data,
        device=device)
    specs = ref.param_specs(spec)
    model, _ = build_model(cfg, device)
    model.load_state_dict(ref.make_weights(specs, seeds.weights, device),
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

    # the gradients as the update takes them: AdamW's first moment after
    # step 1 over 1 - b1, and after step 2 less b1 times step 1's
    opt = state.main_opt
    live = list(model.named_parameters())
    moments, grads = [], {}

    def after_step(o, args, kwargs):
        if grads:
            return
        m = {n: o.state[p]["exp_avg"] for n, p in live}
        if not moments:
            moments.append({n: t.clone() for n, t in m.items()})
            return
        m1 = moments.pop()
        grads["grad"] = {n: (m1[n] / (1 - B1)).norm() for n in m1}
        grads["grad2"] = {n: ((m[n] - B1 * m1[n]) / (1 - B1)).norm()
                          for n in m1}

    hook = opt.register_step_post_hook(after_step)
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
    w0 = ref.make_weights(specs, seeds.weights, device)
    prog = {"loss": torch.cat(losses).tolist(),
            "grad": _floats(grads["grad"]), "grad2": _floats(grads["grad2"]),
            "update": _floats({n: (p.detach() - w0[n]).norm()
                               for n, p in live})}
    del w0, losses, moments, grads
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
    del feed, loader, dataset, step_fn, pre, state, model, opt, live
    del hook, loop, preprocess, after_step, step, checked
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
              flops_per_step=lambda: step_flops(spec, batch),
              attn_least_ms_per_step=lambda: attn_least_ms(spec, batch))
    return harness.Outcome(
        end_to_end={"train_clips_per_s": steps * batch / window_s,
                    "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
        ctx=ctx, attempted=steps, failed=0, correct=ok, compared=compared,
        memory_peak_bytes=peak, trace=tr_obj)


def train_batches(pool, batch: int, count: int, seed: int,
                  input_size: int):
    """The loader's first ``count`` batches of epoch 0: pool indices and
    the random-sized crops and flips, drawn in turn from the crop
    generator (``reference/data.py``'s order and generator)."""
    order = ref_data.train_order(DATASET_LENGTH, seed)
    rng = ref_data.crop_rng(seed)
    out = []
    for k in range(count):
        idx = order[k * batch:(k + 1) * batch] % pool.size
        out.append((idx, ref.random_sized_crops(pool.hw[idx], rng,
                                                input_size)))
    return out


def follow(spec, block, pool, batch, steps, seeds, device, *,
           prec: str = "fp32", keep=None, grad_hook=None) -> dict:
    """The reference through the first ``steps`` steps, from the weights
    and raw data made from the seed: per-step loss, the first two
    gradients' and the change's leaf norms. ``prec``, ``keep`` (the first
    rows of each batch only) and ``grad_hook`` (a leaf's gradient
    altered) make the control and the faults
    (benchmark/tools/control_mvit.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w0 = ref.make_weights(ref.param_specs(spec), seeds.weights, device)
    trainer = ref.Trainer(spec, w0, prec=ref_model.Prec(prec),
                          ckpt=device.type == "cuda")
    losses, taken_norms = [], []
    for s, (idx, crops) in enumerate(train_batches(
            pool, batch, steps, seeds.loader, spec.input_size)):
        idx = idx[:keep]
        x = ref_data.inputs(pool, ["rgb"], idx,
                            {"rgb": tuple(a[:keep] for a in crops)}, 1,
                            spec.frames, spec.input_size, 1, 1.0,
                            device)["rgb"][:, 0]
        target = torch.from_numpy(pool.labels[idx]).to(device)
        _, drop = ref_model.noise(device, seeds.steps, s)
        loss, taken = trainer.step(x, target, drop, grad_hook)
        losses.append(loss)
        if len(taken_norms) < 2:
            taken_norms.append(_floats({n: g.norm()
                                        for n, g in taken.items()}))
        del x, taken
    return {"loss": losses, "grad": taken_norms[0], "grad2": taken_norms[1],
            "update": _floats({n: (trainer.params[n] - w0[n]).norm()
                               for n in trainer.live})}
