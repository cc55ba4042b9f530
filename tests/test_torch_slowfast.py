"""SlowFast 8x8 R50 (``models/slowfast.py``) against its plain reference
(``tests/plain_slowfast.py``, plain torch, NCDHW ``F.conv3d``, no code of
the port), in float32 on the CPU, at a small size: width 8 a group (the
fast pathway's stem 1 channel), 8 fast and 2 slow frames, 32x32 crops, 4
clips, 5 classes, on the reference's seeded random weights. Besides: the
published widths on the meta device, the slow frames, PySlowFast's init,
the spans of an eager profiled step, train_unimodal on synthetic data
with a checkpoint resumed, and validate_args's refusals.

Tolerances: the port's convolutions run channels-last (the [1, k, k]
ones as 2D convolutions of the folded frames) and its train-mode BN takes
the variance as E[x^2] - E[x]^2 where the reference subtracts the mean
first, so float32 sums land in another order. At this width the fast
pathway's stem and res2 hold 1 and 4 channels and the res5 BNs take
moments over 8 values a channel (4 clips x 2 slow frames x 1 x 1), which
magnifies that round-off: some BN biases' gradients are differences of
nearly equal terms (in float64 the port and the reference agree to
3e-6 of such a leaf, in float32 to about a fifth of the median leaf).
So every leaf is held to the reference in float64 to 1e-5 of the leaf,
and in float32 to a tenth of the larger of the leaf and the median leaf,
with the median leaf's gap under 2e-3 and the logits within 1e-3 (float32
reads about 1.5e-4 and 1.6e-4). Computing in bfloat16 (8 bits of mantissa
against float32's 24) misses the logits' and the median's tolerances by
tenfold and more."""

import math
import statistics

import pytest
import torch

from adamml_tpu_torch.cli import train_unimodal
from adamml_tpu_torch.configs.config import (arg_parser, config_from_args,
                                             validate_args)
from adamml_tpu_torch.models import model_builder
from adamml_tpu_torch.models import slowfast as tsf
from adamml_tpu_torch.models.layers import Conv3d
from adamml_tpu_torch.models.norm import GroupedBatchNorm
from adamml_tpu_torch.models.resnet_tsn import Bottleneck
from adamml_tpu_torch.train.optim import SGD
from adamml_tpu_torch.train.steps import (make_unimodal_train_step,
                                          step_generators)
from adamml_tpu_torch.train.train_state import TrainState
from adamml_tpu_torch.utils.flops import count_model_flops

import plain_slowfast as plain
from torch_parity import one_torch_thread  # noqa: F401

SPEC = plain.Spec(num_classes=5, width=8, frames=8, input_size=32, lr=0.1)
N = 4
FULL = ["--backbone_net", "slowfast", "-d", "50", "--modality", "rgb",
        "--dataset", "kinetics400", "--groups", "32", "--frames_per_group",
        "2", "--num_segments", "1", "--dense_sampling"]


def _model(spec=SPEC, dtype=torch.float32):
    return tsf.SlowFast(num_classes=spec.num_classes, width=spec.width,
                        frames=spec.frames, dropout=spec.dropout, dtype=dtype)


def _weights(seed=3):
    return plain.make_weights(plain.param_specs(SPEC), seed, "cpu",
                              bn_scale_std=0.2)


def _clips(seed=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, SPEC.frames, SPEC.input_size, SPEC.input_size, 3),
                    generator=g)
    target = torch.randint(0, SPEC.num_classes, (N,), generator=g)
    return x, target


def _loaded(w, dtype=torch.float32):
    model = _model(dtype=dtype)
    model.load_state_dict(w, strict=True)
    return model


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_the_names_and_shapes_are_the_reference_s():
    got = {k: tuple(v.shape) for k, v in _model().state_dict().items()}
    want = {n: s for n, s, _ in plain.param_specs(SPEC)}
    assert got == want


def _logits(w, x, train, dtype=torch.float32):
    gen = step_generators(torch.device("cpu"), 11, 0)[1]
    model = _loaded(w, dtype)
    if dtype == torch.float64:
        model = model.double()
    with torch.no_grad():
        got = model(x.to(dtype), train=train, generator=gen)
    want, _ = plain.forward(
        {k: v for k, v in w.items() if not plain.is_statistic(k)},
        {k: v for k, v in w.items() if plain.is_statistic(k)}, SPEC,
        x.to(w["fc.weight"].dtype), train=train,
        dropout=step_generators(torch.device("cpu"), 11, 0)[1])
    assert got.dtype == torch.float32 and got.shape == (N, 5)
    return _gap(got.to(want.dtype), want)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_logits_match_the_reference(train):
    x, _ = _clips()
    assert _logits(_weights(), x, train) < 1e-3
    w64 = {k: v.double() for k, v in _weights().items()}
    assert _logits(w64, x, train, torch.float64) < 1e-6


def test_bfloat16_misses_the_logits_tolerance():
    x, _ = _clips()
    for train in (True, False):
        assert _logits(_weights(), x, train, torch.bfloat16) > 1e-2


def _one_step(w, dtype=torch.float32):
    """One SGD step of the port (its unimodal train step) and of the
    reference from weights w: (port loss, reference loss, port gradients
    as the update takes them, reference's, port state, reference state)."""
    x, target = _clips()
    model = _loaded(w, dtype)
    if dtype == torch.float64:
        model, x = model.double(), x.double()
    opt = SGD(model.parameters(), lr=SPEC.lr, momentum=SPEC.momentum,
              weight_decay=SPEC.weight_decay, foreach=True)
    state = TrainState(opt, None)
    metrics = make_unimodal_train_step(model, clip_gradient=None)(
        state, x, target, SPEC.lr, 11)
    grads = {n: opt.state[p]["momentum_buffer"]
             for n, p in model.named_parameters()}
    trainer = plain.Trainer(SPEC, w, ckpt=False)
    loss, taken = trainer.step(
        x.to(w["fc.weight"].dtype), target,
        step_generators(torch.device("cpu"), 11, 0)[1])
    ref_state = dict(trainer.params, **trainer.stats)
    return (float(metrics["loss"]), loss, grads, taken, model.state_dict(),
            ref_state)


def _leaf_gaps(got, want):
    """Each leaf's largest gap over the larger of its own and the median
    leaf's largest reference value."""
    med = statistics.median(float(v.abs().max()) for v in want.values())
    return {n: float((got[n].to(v.dtype) - v).abs().max())
            / max(float(v.abs().max()), med) for n, v in want.items()}


def test_loss_gradients_update_and_bn_statistics_match():
    w = _weights()
    loss, ref_loss, grads, taken, got, want = _one_step(w)
    assert abs(loss - ref_loss) / ref_loss < 1e-5
    assert set(grads) == set(taken) and set(got) == set(want)
    change = {n: got[n] - w[n] for n in want}
    for gaps in (_leaf_gaps(grads, taken),
                 _leaf_gaps(change, {n: v - w[n] for n, v in want.items()})):
        assert max(gaps.values()) < 0.1, max(gaps, key=gaps.get)
        assert statistics.median(gaps.values()) < 2e-3
    for n in want:
        if n.endswith(("running_mean", "running_var")):
            assert _gap(got[n] - w[n], want[n] - w[n]) < 1e-3, n


def test_every_leaf_matches_in_float64():
    w = {k: v.double() for k, v in _weights().items()}
    loss, ref_loss, grads, taken, got, want = _one_step(w, torch.float64)
    # the port hands its logits on in float32
    assert abs(loss - ref_loss) / ref_loss < 1e-6
    for name, g in grads.items():
        assert _gap(g, taken[name]) < 1e-5, name
    for name, v in want.items():
        assert _gap(got[name] - w[name], v - w[name]) < 1e-5, name


def test_bfloat16_misses_the_gradient_tolerance():
    w = _weights()
    _, _, grads, taken, _, _ = _one_step(w, torch.bfloat16)
    assert statistics.median(_leaf_gaps(grads, taken).values()) > 2e-2


def test_multi_clip_rows_average_their_clips():
    """Rows of k clips (T = k x frames, the unimodal preprocessor's fold of
    multi-clip eval) give the mean of each clip's logits."""
    model = _loaded(_weights())
    x, _ = _clips()
    y, _ = _clips(seed=5)
    with torch.no_grad():
        both = model(torch.cat([x, y], 1))
        each = (model(x) + model(y)) / 2
    assert _gap(both, each) < 1e-6


def test_slow_frames():
    assert tsf.slow_frames(32).tolist() == [0, 4, 8, 13, 17, 22, 26, 31]
    assert tsf.slow_frames(8).tolist() == [0, 7]
    assert torch.equal(tsf.slow_frames(32), plain.slow_frames(32))


def test_published_widths_and_fusion_shapes():
    """The full model on the meta device: 400 classes, the fusions' outputs
    80, 320, 640 and 1280 channels over 8 frames, the head 2048 + 256."""
    with torch.device("meta"):
        model = tsf.SlowFast()
    seen = {}
    for name, mod in model.fuse.items():
        mod.register_forward_hook(
            lambda m, a, out, name=name: seen.__setitem__(name, out.shape))
    head = {}
    model.fc.register_forward_hook(
        lambda m, a, out: head.__setitem__("in", a[0].shape))
    out = model(torch.empty((2, 32, 224, 224, 3), device="meta"))
    assert out.shape == (2, 400)
    assert seen == {"stem": (2, 8, 56, 56, 80), "res2": (2, 8, 56, 56, 320),
                    "res3": (2, 8, 28, 28, 640),
                    "res4": (2, 8, 14, 14, 1280)}
    assert head["in"] == (2, 2304)
    n = sum(p.numel() for p in model.parameters())
    assert 34_000_000 < n < 35_000_000


def test_3d_convolutions_are_counted():
    """The FLOP count of the eval forward: every 3D convolution and the fc,
    2 a multiply-add, as the reference's convolutions count them."""
    from torch.utils.flop_counter import FlopCounterMode

    w = _weights()
    x, _ = _clips()
    got = count_model_flops(_loaded(w), x, train=False)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        plain.forward({k: v for k, v in w.items()
                       if not plain.is_statistic(k)},
                      {k: v for k, v in w.items() if plain.is_statistic(k)},
                      SPEC, x, train=False)
    want = counter.get_total_flops()
    assert got == want and got > 0


def test_init_model_follows_pyslowfast():
    cfg = config_from_args(arg_parser().parse_args(FULL))
    model, arch = model_builder.build_model(cfg, "cpu")
    assert "slowfast-r50" in arch
    assert cfg.model.num_classes == 400
    last = {id(m.cb3.bn) for m in model.modules() if isinstance(m, Bottleneck)}
    assert len(last) == 32
    z = []
    for mod in model.modules():
        if isinstance(mod, GroupedBatchNorm):
            assert torch.all(mod.weight == (0.0 if id(mod) in last else 1.0))
            assert torch.all(mod.bias == 0)
        elif isinstance(mod, Conv3d):
            w = mod.weight.detach()
            z.append(w.flatten() / math.sqrt(
                2.0 / (w.shape[0] * math.prod(w.shape[2:]))))
    # Kaiming normal with fan-out: 34 M draws over their own scales
    assert abs(float(torch.cat(z).std()) - 1) < 0.01
    fc = model.fc.weight.detach()
    assert fc.shape == (400, 2304)
    assert abs(float(fc.std()) / 0.01 - 1) < 0.02
    assert torch.all(model.fc.bias == 0)


def test_spans_bracket_forward_and_backward_of_an_eager_step(tmp_path):
    """In a profiled eager train step every convolution's forward and
    backward lies inside a ``model.slow``, ``model.fast`` or ``model.fuse``
    range (the backward's too, the stems' included), those ranges never
    overlap on one thread, and each backward range is a forward's twin."""
    import json

    model = _loaded(_weights())
    x, target = _clips()
    opt = SGD(model.parameters(), lr=0.1, momentum=0.9, foreach=True)
    step = make_unimodal_train_step(model, clip_gradient=None)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        step(TrainState(opt, None), x, target, 0.1, 3)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    names = ("model.slow", "model.fast", "model.fuse")
    spans = [e for e in events if e.get("name") in names]
    by = {n: [e for e in spans if e["name"] == n] for n in names}
    # forward: 5 stages a pathway, 4 fusions; each also in the backward
    assert {n: len(v) for n, v in by.items()} == {
        "model.slow": 10, "model.fast": 10, "model.fuse": 8}
    wins = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["tid"]) for e in spans)
    for (a0, a1, ta), (b0, b1, tb) in zip(wins, wins[1:]):
        assert ta != tb or a1 <= b0
    convs = [e for e in events if e.get("name") in (
        "aten::convolution", "aten::convolution_backward")]
    assert len(convs) == 2 * len([1 for _, _, k in plain.param_specs(SPEC)
                                  if k == "conv"])
    for c in convs:
        ts = float(c["ts"])
        inside = [w for w in wins if w[2] == c["tid"] and w[0] <= ts <= w[1]]
        assert len(inside) == 1, c["name"]


def test_spans_cost_nothing_unprofiled(monkeypatch):
    """With no profiler and no capture the spans make no autograd node: the
    gradient graph is the one without spans."""
    import adamml_tpu_torch.utils.profiling as profiling

    model = _loaded(_weights())
    x, _ = _clips()

    def count(out):
        seen, stack = set(), [out.grad_fn]
        while stack:
            n = stack.pop()
            if n is None or n in seen:
                continue
            seen.add(n)
            stack.extend(m for m, _ in n.next_functions)
        return len(seen)

    with_spans = count(model(x, train=False))
    monkeypatch.setattr(tsf, "spanned", lambda name, fn, x, *a: fn(x, *a))
    assert count(model(x, train=False)) == with_spans
    assert profiling._capture is None


@pytest.fixture
def tiny_slowfast(monkeypatch):
    """build_model's SlowFast at width 8 (the published model has no width
    flag)."""
    made = tsf.SlowFast

    def small(**kw):
        kw["width"] = 8
        return made(**kw)

    monkeypatch.setattr(model_builder, "SlowFast", small)


def test_train_unimodal_trains_evaluates_and_resumes(tmp_path,
                                                     tiny_slowfast):
    argv = ["--dataset", "synthetic", "--modality", "rgb", "--backbone_net",
            "slowfast", "-d", "50", "--groups", "8", "--frames_per_group",
            "1", "--num_segments", "1", "--dense_sampling", "-b", "4",
            "--epochs", "1", "--input_size", "32", "--synthetic_length", "4",
            "--val_num_clips", "1", "--compute_dtype", "float32", "-j", "2",
            "--lr_scheduler", "multisteps", "--lr_steps", "1",
            "--scale_range", "36", "48", "--logdir", str(tmp_path)]
    assert train_unimodal.main(argv, device="cpu") == 0
    folder = next(p for p in tmp_path.iterdir() if p.is_dir())
    assert "slowfast-r50" in folder.name
    assert {"checkpoint", "checkpoint_01", "log.log"} <= {
        p.name for p in folder.iterdir()}
    assert train_unimodal.main(
        argv[:argv.index("--epochs") + 1] + ["2"]
        + argv[argv.index("--epochs") + 2:]
        + ["--resume", str(folder / "checkpoint")], device="cpu") == 0
    second = next(p for p in tmp_path.iterdir() if p.name.endswith("-e2"))
    lines = (second / "log.log").read_text().splitlines()
    assert any("loaded checkpoint" in line and "(epoch 1)" in line
               for line in lines)
    # the resumed run trains and validates epoch 2 only
    assert [line.split(":")[0] for line in lines
            if line.startswith(("Train:", "Val:"))] == ["Train", "Val"]
    assert "[002/002]" in [line for line in lines
                           if line.startswith("Train:")][-1]


def test_show_model_counts_slowfast(capsys, tiny_slowfast):
    argv = ["--dataset", "synthetic", "--modality", "rgb", "--backbone_net",
            "slowfast", "--groups", "8", "--input_size", "32",
            "--show_model"]
    assert train_unimodal.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Total params" in out and "GFLOPs" in out


@pytest.mark.parametrize("change,flag", [
    (["--modality", "flow"], "--modality"),
    (["--num_segments", "2"], "--num_segments"),
    (["--groups", "30"], "--groups"),
    (["-d", "101"], "--depth"),
], ids=["modality", "segments", "frames", "depth"])
def test_validate_args_refuses_what_slowfast_cannot_take(change, flag):
    parser = arg_parser()
    args = parser.parse_args(FULL + change)
    with pytest.raises(ValueError, match=flag):
        validate_args(parser, args)
