"""The plain reference against adamml_tpu_torch on the CPU, at a tiny size
of the flagship's structure (float32 on both sides): the configurations'
flags against their reference blocks, the weights' names and shapes, the
preprocessing of the card, the eval forward, and the first train step of
both phases.

The tiny model's gradient is ill-conditioned beyond the first step (at
8 clips of 64 px the program's own gradient moves by percents for a 1e-6
change of its weights), so steps are compared one at a time from one
state, and gradients by the median leaf."""

import statistics

import numpy as np
import pytest
import torch

from adamml_tpu_torch.configs.config import arg_parser, config_from_args
from adamml_tpu_torch.data.dataflow import HostDataLoader
from adamml_tpu_torch.data.device_pipeline import make_batch_preprocessor
from adamml_tpu_torch.models.model_builder import build_model
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.steps import make_adamml_train_step
from adamml_tpu_torch.train.train_state import StageFlags, TrainState
from benchmark import harness
from benchmark.reference import data as ref_data
from benchmark.reference import model as ref
from benchmark.sources import canvas_pool
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", ["flagship", "rgbflow"])
def test_flags_and_reference_block_agree(name):
    cell = harness.load_cell(f"{name}.train-main")
    conf = cell.config
    cfg = config_from_args(arg_parser().parse_args(conf["flags"]))
    spec = ref.Spec.from_dict(conf["reference"])
    m, o, d = cfg.model, cfg.optim, cfg.data
    assert tuple(m.modality) == spec.modality
    assert (m.num_classes, m.groups, m.num_segments) == (
        spec.num_classes, spec.frames, spec.segments)
    assert (d.input_size, m.policy_input_size) == (spec.input_size,
                                                   spec.policy_input_size)
    assert (d.audio_length, d.resampling_rate) == (spec.audio_length,
                                                   spec.resampling_rate)
    assert tuple(d.canvas_size) == spec.canvas
    assert tuple(d.scale_range) == spec.scale_range
    assert (m.dropout, m.gammas, tuple(m.cost_weights)) == (
        spec.dropout, spec.gammas, spec.cost_weights)
    assert (o.lr, o.p_lr, o.momentum, o.weight_decay) == (
        spec.lr, spec.p_lr, spec.momentum, spec.weight_decay)
    assert (o.batch_size, o.steps_per_dispatch) == (
        cell.traffic["batch"], cell.traffic["steps_per_dispatch"])
    assert (m.depth, m.compute_dtype, m.causality_modeling) == (
        50, "bfloat16", "lstm")
    assert m.learnable_lf_weights and m.penalty_type == "blockdrop"
    assert d.augmentor_ver == "v2" and not o.nesterov


def _tiny(modality=("rgb", "sound")):
    conf = dict(tiny.REFERENCE, modality=list(modality))
    cfg = config_from_args(arg_parser().parse_args(tiny.flags_for(modality)))
    return cfg, ref.Spec.from_dict(conf)


@pytest.mark.parametrize("modality", [("rgb", "sound"),
                                      ("rgb", "flow", "rgbdiff")])
def test_weights_load_into_the_program_by_name(modality):
    cfg, spec = _tiny(modality)
    model, _ = build_model(cfg, "cpu")
    w = ref.make_weights(ref.param_specs(spec), 3, "cpu")
    model.load_state_dict(w, strict=True)
    again = ref.make_weights(ref.param_specs(spec), 3, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def _pool(spec, samples, segments, seed=4):
    return canvas_pool.make(
        list(spec.modality), samples=samples, segments=segments,
        frames_per_segment=spec.frames, canvas=spec.canvas,
        wave_samples=round(spec.resampling_rate * spec.audio_length),
        num_classes=spec.num_classes, seed=seed, device="cpu")


@pytest.mark.parametrize("modality", [("rgb", "sound"),
                                      ("rgb", "flow", "rgbdiff")])
@pytest.mark.parametrize("train", [True, False])
def test_preprocessing_matches_the_program(modality, train):
    cfg, spec = _tiny(modality)
    pool = _pool(spec, 4, spec.segments)
    loader = HostDataLoader(
        canvas_pool.Dataset(pool, list(modality), 1000 if train else 4), 4,
        is_train=train, input_size=spec.input_size, workers=1, seed=9)
    host = next(iter(loader))
    pre = make_batch_preprocessor(cfg, train=train,
                                  num_segments=spec.segments, device="cpu")
    got, target = pre(host)
    visual = [m for m in modality if m != "sound"]
    if train:
        b = ref_data.train_batches(pool, visual, 4, 1, 1000, 9,
                                   spec.input_size, spec.scale_range)[0]
        idx, crops = b["index"], {m: b[m] for m in visual}
    else:
        idx = np.arange(4)
        crops = {m: (ref_data.center_crops(pool.hw[idx], spec.input_size),
                     np.zeros(4, bool)) for m in visual}
    want = ref_data.inputs(pool, list(modality), idx, crops, spec.segments,
                           spec.frames, spec.input_size,
                           spec.resampling_rate, spec.audio_length, "cpu")
    assert torch.equal(target.long(), torch.from_numpy(pool.labels[idx]))
    for m, x in zip(modality, got):
        assert x.shape == want[m].shape, m
        scale = want[m].abs().max()
        assert float((x - want[m]).abs().max()) <= 1e-4 * scale, m


@pytest.mark.parametrize("modality", [("rgb", "sound"),
                                      ("rgb", "flow", "rgbdiff")])
def test_eval_forward_matches_the_program(modality):
    cfg, spec = _tiny(modality)
    model, _ = build_model(cfg, "cpu")
    w = ref.make_weights(ref.param_specs(spec), 3, "cpu")
    model.load_state_dict(w, strict=True)
    gen = torch.Generator().manual_seed(1)
    inputs = {m: torch.randn((4, 2, 1, 256, 32, 1) if m == "sound" else
                             (4, 2, 4, 64, 64, ref.CHANNELS[m]),
                             generator=gen) for m in modality}
    g1, _ = ref.noise("cpu", 5, 0)
    with torch.no_grad():
        lp, dp = model([inputs[m] for m in modality], spec.temperature,
                       train=False, generator=g1)
        g2, _ = ref.noise("cpu", 5, 0)
        lr, dr, _ = ref.forward(
            {k: v for k, v in w.items() if not ref.is_statistic(k)},
            {k: v for k, v in w.items() if ref.is_statistic(k)}, spec,
            inputs, train=False, gumbel=g2)
    assert torch.equal(dp, dr)
    assert float((lp - lr).abs().max()) <= 1e-5 * float(lr.abs().max())


@pytest.mark.parametrize("phase", ["main", "policy"])
def test_first_train_step_matches_the_program(phase):
    cfg, spec = _tiny()
    cfg.data.input_size = 64
    model, _ = build_model(cfg, "cpu")
    w = ref.make_weights(ref.param_specs(spec), 3, "cpu")
    model.load_state_dict(w, strict=True)
    state = TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()),
        temperature=spec.temperature)
    flags = (StageFlags.main_phase() if phase == "main"
             else StageFlags.policy_phase())
    step = make_adamml_train_step(model, flags=flags,
                                  penalty_type="blockdrop", gammas=10.0,
                                  clip_gradient=None)
    gen = torch.Generator().manual_seed(2)
    inputs = {"rgb": torch.randn((8, 2, 4, 64, 64, 3), generator=gen),
              "sound": torch.randn((8, 2, 1, 256, 32, 1), generator=gen)}
    target = torch.arange(8) % spec.num_classes
    cost = [0.0, 0.0] if phase == "main" else list(spec.cost_weights)
    got = step(state, [inputs["rgb"], inputs["sound"]], target, spec.lr,
               spec.p_lr, cost, 7)
    trainer = ref.Trainer(spec, w, phase, ckpt=True)
    loss, taken = trainer.step(inputs, target, *ref.noise("cpu", 7, 0),
                               cost)
    assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
    opt = state.main_opt if phase == "main" else state.policy_opt
    params = dict(model.named_parameters())
    prog = {}
    for k in taken:
        st = opt.state[params[k]]
        prog[k] = float((st["momentum_buffer"] if phase == "main"
                         else st["exp_avg"] / 0.1).norm())
    gaps = [abs(prog[k] - float(t.norm())) / float(t.norm())
            for k, t in taken.items()]
    assert statistics.median(gaps) < 1e-3
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith("running_var")}
    var = [float((stats[k] - trainer.stats[k]).norm()
                 / (trainer.stats[k] - w[k]).norm()) for k in stats]
    assert statistics.median(var) < 1e-3
