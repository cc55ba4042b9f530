"""The SlowFast cell (``slowfast8x8.train``) on the CPU at a tiny size
(width 8, 8 fast and 2 slow frames, 32 px, 4 clips, float32): its
configuration's flags against its reference block, the reference against
the program, a rehearsal of the ``train_unimodal`` entry down to its
result line, the readers of the model spans, the control and the faults
failing the cell's limits, and faults planted in the program turning
``correct`` false. The program is built at width 8 (it has no width
flag): ``model_builder.SlowFast`` is patched for the tests."""

import copy
import filecmp
import functools
import json

import pytest
import torch

import adamml_tpu_torch.models.model_builder as model_builder
import adamml_tpu_torch.models.norm as norm
import adamml_tpu_torch.models.slowfast as tsf
import adamml_tpu_torch.train.steps as steps
from adamml_tpu_torch.configs.config import arg_parser, config_from_args
from benchmark import harness, model_spans
from benchmark.entries import train_unimodal as entry
from benchmark.reference import slowfast as ref
from benchmark.tests.test_faults import half_batch_loss, state_unchanged
from benchmark.tools import control_unimodal
from benchmark.trace import Trace

NAME = "slowfast8x8.train"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# at this size the cell's learning rate sends the loss from 6 to 35 and to
# nan within 3 steps (the width-8 net's features over a 4-clip batch): a
# smaller one keeps the tiny steps in range
TINY = {"num_classes": 400, "width": 8, "frames": 8, "input_size": 32,
        "canvas": [64, 96], "lr": 0.02}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def width8(monkeypatch):
    made = tsf.SlowFast
    monkeypatch.setattr(model_builder, "SlowFast",
                        functools.partial(made, width=TINY["width"]))


def tiny_cell(**traffic_changes) -> harness.Cell:
    real = harness.load_cell(NAME)
    traffic = copy.deepcopy(real.traffic)
    traffic.update(batch=4, pool_batches=2, workers=2,
                   trace={"skip_steps": 1, "steps": 1})
    traffic.update(traffic_changes)
    flags = list(real.config["flags"])
    for flag, value in (("--groups", "8"), ("-b", "4"),
                        ("--input_size", "32"), ("--lr", str(TINY["lr"]))):
        flags[flags.index(flag) + 1] = value
    flags += ["--compute_dtype", "float32"]
    config = dict(real.config, flags=flags,
                  reference=dict(real.config["reference"], **TINY))
    return harness.Cell(name=NAME, chips=1, config=config, traffic=traffic,
                        end_to_end=real.end_to_end, per_layer=real.per_layer)


def test_flags_and_reference_block_agree():
    cell = harness.load_cell(NAME)
    conf, block = cell.config, cell.config["reference"]
    cfg = config_from_args(arg_parser().parse_args(conf["flags"]))
    m, o, d = cfg.model, cfg.optim, cfg.data
    assert (m.backbone_net, m.depth, m.modality, m.num_segments) == (
        "slowfast", 50, ["rgb"], 1)
    assert (m.num_classes, m.groups, m.frames_per_group) == (
        block["num_classes"], block["frames"], 2)
    assert d.dense_sampling and m.compute_dtype == "bfloat16"
    assert (d.input_size, list(d.scale_range)) == (block["input_size"],
                                                   block["scale_range"])
    assert (m.dropout, o.lr, o.momentum, o.weight_decay) == (
        block["dropout"], block["lr"], block["momentum"],
        block["weight_decay"])
    assert o.batch_size == cell.traffic["batch"] and not o.nesterov
    assert block["width"] == 64 and block["canvas"] == [256, 340]
    # the recipe's warm-up start, 0.01 at 64 clips, scaled to eight cards'
    # global batch
    assert o.lr == pytest.approx(0.01 * 8 * o.batch_size / 64)


def test_the_reference_is_the_tests_plain_copy():
    assert filecmp.cmp(harness.ROOT / "benchmark/reference/slowfast.py",
                       harness.ROOT / "tests/plain_slowfast.py",
                       shallow=False)


def test_the_weights_load_into_the_program_by_name():
    cell = tiny_cell()
    cfg = config_from_args(arg_parser().parse_args(cell.config["flags"]))
    model, _ = model_builder.build_model(cfg, "cpu")
    spec = ref.Spec.from_dict(cell.config["reference"])
    model.load_state_dict(ref.make_weights(ref.param_specs(spec), 5, "cpu"),
                          strict=True)


def rehearse(trace: bool, cell=None):
    cell = cell or tiny_cell()
    out = harness.entry(cell.traffic["entry"]).run(
        cell, 2 ** 31 + 4321, 4.0 if trace else 1.0, trace,
        torch.device("cpu"), __import__("time").perf_counter())
    return cell, out, harness.result_line(cell, out, trace=trace, kind="cpu",
                                          count=1)


def test_the_result_line_has_the_required_keys_and_the_check_passes():
    cell, out, line = rehearse(False)
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(line["metrics"]) == {"train_clips_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["compared"]) == set(cell.traffic["limits"])
    # float32 on both sides: the first step agrees; at this size the later
    # steps magnify round-off (a float64 program moves the median leaf's
    # change by 6e-4 after 3 steps), so the later numbers are the card's
    nums = out.ctx.numbers
    assert nums["loss_step1"] < 1e-5 and nums["grad_median"] < 1e-4, nums
    json.dumps(line)


def test_a_traced_run_reads_its_per_layer_metrics():
    cell, out, line = rehearse(True)
    names = {m["name"] for m in cell.per_layer}
    assert {"slow_path_ms_per_step.train", "fast_path_ms_per_step.train",
            "fuse_ms_per_step.train", "bn_eager_ms_per_step.train",
            "train_mfu", "loader_wait_share.train"} <= names
    assert set(line["metrics"]) <= names
    assert "loader_wait_share.train" in line["metrics"]
    # the spans are in the trace, forward on the main thread and backward
    spans = [e for e in out.ctx.events if e.get("cat") == "user_annotation"
             and e.get("name") in ("model.slow", "model.fast",
                                   "model.fuse")]
    assert len(spans) >= 2 * 14
    # every train-mode BN's span, forward and backward, in each traced step
    bns = sum(isinstance(m, norm.GroupedBatchNorm)
              for m in tsf.SlowFast(width=TINY["width"],
                                    frames=TINY["frames"]).modules())
    bn_spans = [e for e in out.ctx.events if e.get("name") == "model.bn"
                and e.get("cat") == "user_annotation"]
    assert len(bn_spans) >= 2 * bns
    assert {"busy_s", "window_s"} <= set(line["device"])


def _trace(events, units=2):
    stretch = {"ph": "X", "cat": "user_annotation", "name": "bench.stretch",
               "ts": 0, "dur": 1000, "tid": 1}
    return Trace([stretch] + events, units, units)


def _ev(name, cat, ts, dur, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_model_spans_count_launches_on_any_thread():
    """Forward spans on the main thread (1), backward's on another (2): a
    kernel counts when its launch lies in a span of its own thread."""
    events = [
        _ev("model.fast", "user_annotation", 10, 20, 1),
        _ev("model.fast", "user_annotation", 500, 50, 2),
        _ev("model.slow", "user_annotation", 40, 20, 1),
        _ev("cudaLaunchKernel", "cuda_runtime", 15, 1, 1, 1),
        _ev("cudaLaunchKernel", "cuda_runtime", 45, 1, 1, 2),
        _ev("cudaLaunchKernel", "cuda_runtime", 510, 1, 2, 3),
        # launched on thread 1 while thread 2's span is open: not fast's
        _ev("cudaLaunchKernel", "cuda_runtime", 520, 1, 1, 4),
        _ev("k1", "kernel", 100, 300, 7, 1),
        _ev("k2", "kernel", 400, 100, 7, 2),
        _ev("k3", "kernel", 600, 60, 7, 3),
        _ev("k4", "kernel", 700, 40, 7, 4),
    ]
    ctx = entry.Ctx(kind="train", trace=_trace(events), events=events)
    assert model_spans.device_ms_per_step(ctx, "model.fast") == \
        pytest.approx((0.300 + 0.060) / 2)
    assert model_spans.device_ms_per_step(ctx, "model.slow") == \
        pytest.approx(0.100 / 2)
    assert model_spans.device_ms_per_step(ctx, "model.fuse") is None
    # an entry that keeps no events (the AdaMML cells) reads nothing
    assert model_spans.device_ms_per_step(
        entry.Ctx(kind="train", trace=_trace(events)), "model.fast") is None


@pytest.mark.parametrize("metric,span", [
    ("slow_path_ms_per_step.train", "model.slow"),
    ("fast_path_ms_per_step.train", "model.fast"),
    ("fuse_ms_per_step.train", "model.fuse"),
    ("bn_eager_ms_per_step.train", "model.bn"),
])
def test_each_model_span_reader_reads_its_own_span(metric, span):
    """Each reader sums the kernels launched inside its span, forward (main
    thread) and backward (another), and reads nothing without it."""
    events = [_ev(span, "user_annotation", 10, 20, 1),
              _ev(span, "user_annotation", 500, 50, 2),
              _ev("model.other", "user_annotation", 40, 20, 1),
              _ev("cudaLaunchKernel", "cuda_runtime", 15, 1, 1, 1),
              _ev("cudaLaunchKernel", "cuda_runtime", 45, 1, 1, 2),
              _ev("cudaLaunchKernel", "cuda_runtime", 510, 1, 2, 3),
              _ev("k1", "kernel", 100, 300, 7, 1),
              _ev("k2", "kernel", 400, 100, 7, 2),
              _ev("k3", "kernel", 600, 60, 7, 3)]
    read = harness.reader(metric).read
    ctx = entry.Ctx(kind="train", trace=_trace(events), events=events)
    assert read(ctx) == pytest.approx((0.300 + 0.060) / 2)
    others = [e for e in events if e["name"] != span]
    assert read(entry.Ctx(kind="train", trace=_trace(others),
                          events=others)) is None


def fails(cell, numbers) -> bool:
    from benchmark import check

    return not check.verdict(numbers, cell.traffic["limits"])[0]


def test_control_and_faults_fail_at_a_tiny_size():
    cell = tiny_cell()
    got = control_unimodal.readings(cell, 3, torch.device("cpu"))
    assert set(got) == {"control", "half_batch", "state_unchanged",
                        "fast_res3_half_grad"}
    for kind, numbers in got.items():
        assert fails(cell, numbers), (kind, numbers)
    assert got["state_unchanged"]["update_median"] == 1.0
    assert got["state_unchanged"]["var_median"] > 0.99
    # the confined fault moves its stage's median of the first gradient,
    # not the median over all leaves
    # (a leaf's gap is over the larger of its norm and the median leaf's,
    # so a halved leaf reads 0.5 or less)
    conf = got["fast_res3_half_grad"]
    assert 0.25 < conf["grad_stage"] <= 0.5 + 1e-3
    assert conf["grad_median"] < 1e-3


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_control_and_faults_fail_at_the_cell_s_size_on_a_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    cell = harness.load_cell(NAME)
    for kind, numbers in control_unimodal.readings(
            cell, seed, torch.device("cuda")).items():
        assert fails(cell, numbers), (kind, numbers)


def fast_res3_half_grad(monkeypatch):
    """The fast pathway's res3 weights take half their gradient (a wrong
    backward confined to one pathway's stage); every other leaf is right."""
    made = steps.make_unimodal_train_step

    def make(model, **kw):
        for name, p in model.named_parameters():
            if entry.stage_of(name) == control_unimodal.CONFINED:
                p.register_hook(lambda g: g * 0.5)
        return made(model, **kw)

    monkeypatch.setattr(steps, "make_unimodal_train_step", make)


def running_stats_unchanged(monkeypatch):
    """Every train-mode BN leaves its running statistics as they were (a
    forward that stops folding its moments in); the parameters train."""
    train = norm.GroupedBatchNorm._train

    def frozen(self, *args):
        self.update_stats = False
        return train(self, *args)

    monkeypatch.setattr(norm.GroupedBatchNorm, "_train", frozen)


@pytest.mark.parametrize("fault,number,least", [
    (state_unchanged, "update_median", 0.99),
    (running_stats_unchanged, "var_median", 0.99),
    (half_batch_loss, "grad_median", 0.1),
    (fast_res3_half_grad, "grad_stage", 0.25),
], ids=lambda v: getattr(v, "__name__", v))
def test_a_fault_in_the_program_turns_correct_false(monkeypatch, fault,
                                                    number, least):
    """Each fault moves its number far past what the program reads (the
    first step's numbers, 1e-5 at this size) and past its limit where the
    cell compares it."""
    fault(monkeypatch)
    cell, out, line = rehearse(False)
    assert line["correct"] is False
    assert out.ctx.numbers[number] > least, out.ctx.numbers
    limit = cell.traffic["limits"].get(number)
    assert limit is None or out.ctx.numbers[number] > limit
