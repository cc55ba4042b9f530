"""The MViTv2 cell (``mvitv2-s16x4.train``) on the CPU at a tiny size
(width 8, 4 blocks with transitions at 1 and 3, K/V stride 4, 4 frames of
32 px, 4 clips, float32): its configuration's flags against its reference
block, the reference against the tests' plain copy, a rehearsal of the
``train_mvit`` entry down to its result line, the four new readers, the
attention's least work by hand, the step's FLOPs against a hand count, the
control and the faults failing the cell's limits, and faults planted in
the program turning ``correct`` false. The program is built small through
``model_builder.MViT``, patched for the tests."""

import copy
import filecmp
import functools
import json
import math

import pytest
import torch
import torch.nn.functional as F

import adamml_tpu_torch.models.model_builder as model_builder
import adamml_tpu_torch.models.mvit as tmv
import adamml_tpu_torch.train.optim as optim
import adamml_tpu_torch.train.steps as steps
from adamml_tpu_torch.configs.config import arg_parser, config_from_args
from benchmark import check, harness
from benchmark.entries import train_mvit as entry
from benchmark.reference import mvit as ref
from benchmark.reference import mvit_work, work
from benchmark.tests.test_faults import half_batch_loss, state_unchanged
from benchmark.tools import control_mvit
from benchmark.trace import Trace

NAME = "mvitv2-s16x4.train"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SMALL = dict(embed_dim=8, depth=4, transitions=[1, 3], kv_stride=4)
TINY = dict(SMALL, frames=4, input_size=32, canvas=[64, 96], lr=1e-3)
NEW = ("pool_ms_per_step.train", "attn_ms_per_step.train",
       "mlp_ms_per_step.train", "attn_roofline.train")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def small(monkeypatch):
    monkeypatch.setattr(model_builder, "MViT", functools.partial(
        tmv.MViT, embed_dim=8, depth=4, transitions=(1, 3), kv_stride=4))


def tiny_cell(**traffic_changes) -> harness.Cell:
    real = harness.load_cell(NAME)
    traffic = copy.deepcopy(real.traffic)
    traffic.update(batch=4, pool_batches=2, workers=2,
                   trace={"skip_steps": 1, "steps": 1})
    traffic.update(traffic_changes)
    flags = list(real.config["flags"])
    for flag, value in (("--groups", "4"), ("-b", "4"),
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
    assert (m.backbone_net, m.modality, m.num_segments) == ("mvit", ["rgb"], 1)
    assert (m.num_classes, m.groups, m.frames_per_group) == (
        block["num_classes"], block["frames"], 4)
    assert d.dense_sampling and m.compute_dtype == "bfloat16"
    assert d.input_size == block["input_size"]
    assert d.augmentor_ver == "random_sized"
    assert (m.dropout, o.lr, o.weight_decay, o.clip_gradient) == (
        block["dropout"], block["lr"], block["weight_decay"], block["clip"])
    assert o.optimizer == "adamw" and o.batch_size == cell.traffic["batch"]
    spec = ref.Spec.from_dict(block)
    assert spec == ref.Spec(lr=4e-4)
    assert block["canvas"] == [256, 340] and conf["reduced"] == []
    # the recipe's BASE_LR 1e-4 at 64 clips, scaled to eight cards' 256
    assert o.lr == pytest.approx(1e-4 * 8 * o.batch_size / 64)


def test_the_reference_is_the_tests_plain_copy():
    assert filecmp.cmp(harness.ROOT / "benchmark/reference/mvit.py",
                       harness.ROOT / "tests/plain_mvit.py", shallow=False)


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
        cell, 2 ** 31 + 4321, 3.0 if trace else 1.0, trace,
        torch.device("cpu"), __import__("time").perf_counter())
    return cell, out, harness.result_line(cell, out, trace=trace, kind="cpu",
                                          count=1)


def test_the_result_line_has_the_required_keys_and_the_check_passes():
    cell, out, line = rehearse(False)
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert set(line["metrics"]) == {"train_clips_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["compared"]) == set(cell.traffic["limits"])
    assert line["correct"] is True, line["compared"]
    # float32 on both sides: the first two steps' gradients agree
    nums = out.ctx.numbers
    assert nums["loss_step1"] < 1e-5 and nums["grad_median"] < 1e-4, nums
    assert nums["grad2_median"] < 1e-3, nums
    json.dumps(line)


def test_a_traced_run_reads_its_per_layer_metrics():
    cell, out, line = rehearse(True)
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW) | {"train_mfu", "loader_wait_share.train"} <= names
    assert set(line["metrics"]) <= names
    # on the CPU the spans hold no device time: the readers of device time
    # read nothing, and the spans are in the trace forward and backward
    assert "loader_wait_share.train" in line["metrics"]
    spans = [e for e in out.ctx.events if e.get("cat") == "user_annotation"
             and e.get("name") in ("model.pool", "model.attn", "model.mlp")]
    assert len(spans) >= 2 * 3 * SMALL["depth"]
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


def _span_events(span):
    return [_ev(span, "user_annotation", 10, 20, 1),
            _ev(span, "user_annotation", 500, 50, 2),
            _ev("model.other", "user_annotation", 40, 20, 1),
            _ev("cudaLaunchKernel", "cuda_runtime", 15, 1, 1, 1),
            _ev("cudaLaunchKernel", "cuda_runtime", 45, 1, 1, 2),
            _ev("cudaLaunchKernel", "cuda_runtime", 510, 1, 2, 3),
            _ev("k1", "kernel", 100, 300, 7, 1),
            _ev("k2", "kernel", 400, 100, 7, 2),
            _ev("k3", "kernel", 600, 60, 7, 3)]


@pytest.mark.parametrize("metric,span", [
    ("pool_ms_per_step.train", "model.pool"),
    ("attn_ms_per_step.train", "model.attn"),
    ("mlp_ms_per_step.train", "model.mlp"),
])
def test_each_model_span_reader_reads_its_own_span(metric, span):
    """Each reader sums the kernels launched inside its span, forward (main
    thread) and backward (another), and reads nothing without it."""
    events = _span_events(span)
    read = harness.reader(metric).read
    ctx = entry.Ctx(kind="train", trace=_trace(events), events=events)
    assert read(ctx) == pytest.approx((0.300 + 0.060) / 2)
    others = [e for e in events if e["name"] != span]
    assert read(entry.Ctx(kind="train", trace=_trace(others),
                          events=others)) is None


def test_the_attention_roofline_reads_least_time_over_span_time():
    events = _span_events("model.attn")
    read = harness.reader("attn_roofline.train").read
    ctx = entry.Ctx(kind="train", trace=_trace(events), events=events,
                    attn_least_ms_per_step=lambda: 0.018)
    assert read(ctx) == pytest.approx(100 * 0.018 / 0.180)
    # a parent without the span, or a cell without the count, reads nothing
    others = [e for e in events if e["name"] != "model.attn"]
    assert read(entry.Ctx(kind="train", trace=_trace(others), events=others,
                          attn_least_ms_per_step=lambda: 0.018)) is None
    assert read(entry.Ctx(kind="train", trace=_trace(events),
                          events=events)) is None


def test_attn_work_at_the_first_block_by_hand():
    """Block 0: 25,089 queries (8 x 56 x 56 and the cls token) onto 393
    keys (8 x 7 x 7 and the cls token), head dim 96, one head."""
    flops, nbytes = mvit_work.attn_work(25089, 393, 96, (8, 7, 7),
                                        (8, 56, 56))
    fwd = 4 * 25089 * 393 * 96 + 2 * 25088 * 96 * (8 + 7 + 7)
    assert flops == 3 * fwd == 11_676_608_640
    # bf16: q, k, v, o forward; q, k, v, o, dO read and dq, dk, dv written
    # backward; tables Rt (8 x 8), Rh and Rw (56 x 7) read twice, their
    # gradients written once
    tables = (8 * 8 + 56 * 7 + 56 * 7) * 96
    assert nbytes == 2 * (96 * (2 * 25089 + 2 * 393) + 96 * (4 * 25089
                                                            + 4 * 393)
                          + 3 * tables)
    # its least time is the FLOPs' (11.8 us a clip), not the bytes' (9 us)
    assert mvit_work.least_s(flops, nbytes) == flops / work.BF16_FLOPS_PER_S
    assert nbytes / work.HBM_BYTES_PER_S < flops / work.BF16_FLOPS_PER_S
    spec = ref.Spec()
    step = mvit_work.attn_least_ms(spec, 32)
    assert step > 32 * 1e3 * flops / work.BF16_FLOPS_PER_S


def _hand_macs(spec: ref.Spec) -> dict:
    """Multiply-adds of one clip's forward at the table's shapes."""
    t, s, _ = ref.patch_grid(spec)
    out = {"patch": 96 * 3 * 3 * 7 * 7 * t * s * s, "linear": 0, "pool": 0,
           "attn": 0, "rel": 0}
    for g in ref.geometry(spec):
        lin, lq, lk = (1 + math.prod(g.grid_in), 1 + math.prod(g.grid_q),
                       1 + math.prod(g.grid_kv))
        d = g.dim_out // g.heads
        out["linear"] += (lin * g.dim_in * 3 * g.dim_out            # qkv
                          + lq * g.dim_out * g.dim_out              # proj
                          + 2 * lq * g.dim_out * 4 * g.dim_out)     # mlp
        if g.dim_in != g.dim_out:
            out["linear"] += lin * g.dim_in * g.dim_out             # skip
        out["pool"] += 27 * g.heads * d * ((lq - 1) + 2 * (lk - 1))
        out["attn"] += 2 * g.heads * lq * lk * d
        out["rel"] += g.heads * (lq - 1) * d * sum(g.grid_kv)
    out["linear"] += 768 * spec.num_classes
    return out


def test_step_flops_within_five_percent_of_a_hand_count():
    """The step's FLOPs (FlopCounterMode over the reference, forward and
    backward) against the table's GEMMs, convolutions and attention by
    hand: 2 FLOPs a multiply-add, the backward twice the forward, but for
    the patch embedding, whose input takes no gradient (its weight's
    only). The hand count's forward is 63.7 G multiply-adds a clip, under
    1% from the paper's 64 G a view (its count of the same layers; it
    leaves out the softmax, norms and elementwise work, as both counts
    here do)."""
    spec = ref.Spec()
    macs = _hand_macs(spec)
    fwd = sum(macs.values())
    assert abs(fwd / 64e9 - 1) < 0.01
    hand = 2 * (3 * fwd - macs["patch"])
    got = mvit_work.step_flops(spec, 1)
    assert abs(got / hand - 1) < 0.05, (got, hand)


def test_the_stage_groups():
    names = [n for n, _, _ in ref.param_specs(ref.Spec())]
    groups = {entry.stage_of(n) for n in names}
    assert groups == {"patch", "s1", "s2", "s3", "s4", "head"}
    assert entry.stage_of("blocks.0.attn.qkv.weight") == "s1"
    assert entry.stage_of("blocks.2.mlp.fc1.bias") == "s2"
    assert entry.stage_of("blocks.13.norm1.weight") == "s3"
    assert entry.stage_of("blocks.14.proj.weight") == "s4"
    assert entry.stage_of("cls_token") == "head"


def fails(cell, numbers) -> bool:
    return not check.verdict(numbers, cell.traffic["limits"])[0]


def test_control_and_faults_fail_at_a_tiny_size():
    cell = tiny_cell()
    got = control_mvit.readings(cell, 3, torch.device("cpu"))
    assert set(got) == {"control", "half_batch", "state_unchanged",
                        "s2_half_grad"}
    for kind, numbers in got.items():
        assert fails(cell, numbers), (kind, numbers)
    assert got["state_unchanged"]["update_median"] == 1.0
    conf = got["s2_half_grad"]
    assert 0.25 < conf["grad_stage"] <= 0.5 + 1e-3
    assert conf["grad_median"] < 0.5


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_control_and_faults_fail_at_the_cell_s_size_on_a_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    cell = harness.load_cell(NAME)
    for kind, numbers in control_mvit.readings(
            cell, seed, torch.device("cuda")).items():
        assert fails(cell, numbers), (kind, numbers)


def no_residual_pooling(monkeypatch):
    """The attention's output without the pooled query added back."""
    made = tmv.pooled_attention

    def wrong(q, k, v, bias, scale):
        return made(q, k, v, bias, scale) - F.pad(q[:, :, 1:], (0, 0, 1, 0))

    monkeypatch.setattr(tmv, "pooled_attention", wrong)


def adamw_state_unchanged(monkeypatch):
    """test_faults' unchanged state, AdamW's step too (torch wraps a
    class's own ``step`` when it first makes one, so AdamW keeps its
    own)."""
    state_unchanged(monkeypatch)
    monkeypatch.setattr(optim.AdamW, "step", optim.Adam.step)


def s2_half_grad(monkeypatch):
    """Stage 2's weights take half their gradient; every other leaf is
    right."""
    made = steps.make_unimodal_train_step

    def make(model, **kw):
        for name, p in model.named_parameters():
            if entry.stage_of(name) == control_mvit.CONFINED:
                p.register_hook(lambda g: g * 0.5)
        return made(model, **kw)

    monkeypatch.setattr(steps, "make_unimodal_train_step", make)


@pytest.mark.parametrize("fault,number,least", [
    (no_residual_pooling, "grad_median", 0.05),
    (adamw_state_unchanged, "update_median", 0.99),
    (half_batch_loss, "grad_median", 0.03),
    (s2_half_grad, "grad_stage", 0.1),
], ids=lambda v: getattr(v, "__name__", v))
def test_a_fault_in_the_program_turns_correct_false(monkeypatch, fault,
                                                    number, least):
    """Each fault moves its number far past what the program reads (1e-5
    and under at this size) and past its limit where the cell compares
    it."""
    fault(monkeypatch)
    cell, out, line = rehearse(False)
    assert line["correct"] is False
    assert out.ctx.numbers[number] > least, out.ctx.numbers
    limit = cell.traffic["limits"].get(number)
    assert limit is None or out.ctx.numbers[number] > limit
