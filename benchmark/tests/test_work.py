"""The work counts of benchmark/reference/work.py against hand counts at
the flagship's shapes (CPU only)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.reference import model as ref
from benchmark.reference import work

STAGES_40 = [(40, 8, 56, 56, 256), (40, 4, 28, 28, 512),
             (40, 2, 14, 14, 1024)]


def test_epilogue_bytes_and_ops_by_hand():
    nbytes, ops = work.tpool_work(40, 8, 56, 56, 256, 2)
    # read y and ident (40 x 8 frames), write 40 x 4 pooled frames, bf16
    assert nbytes == (2 * 40 * 8 + 40 * 4) * 56 * 56 * 256 * 2
    # 4 ops an input element; windows {0,1}, {1,2,3}, {3,4,5}, {5,6,7}
    # compare 1 + 2 + 2 + 2 times
    assert ops == (4 * 40 * 8 + 7 * 40) * 56 * 56 * 256
    nbytes, ops = work.tpool_bwd_work(40, 8, 56, 56, 256, 2)
    assert nbytes == (4 * 40 * 8 + 40 * 4) * 56 * 56 * 256 * 2
    assert ops == 14 * 40 * 8 * 56 * 56 * 256


def test_epilogue_bounds_at_forty_rows():
    fwd = [work.bound_ms(*work.tpool_work(*s, 2)) for s in STAGES_40]
    bwd = [work.bound_ms(*work.tpool_bwd_work(*s, 2)) for s in STAGES_40]
    # PERF.md section 6, the backward kernel's bound: 0.6902, 0.1725,
    # 0.0431, 0.9059 ms in sum
    assert [round(b, 4) for b in bwd] == [0.6902, 0.1725, 0.0431]
    assert round(sum(bwd), 4) == 0.9059
    # the forward's bytes over 3.35 TB/s (its float32 ops take far less)
    assert [round(f, 4) for f in fwd] == [0.3834, 0.0959, 0.024]
    assert work.tpool_work(40, 8, 56, 56, 256, 2)[1] / work.F32_OPS_PER_S \
        < work.tpool_work(40, 8, 56, 56, 256, 2)[0] / work.HBM_BYTES_PER_S


@pytest.mark.parametrize("config,launches", [("flagship", 3),
                                             ("rgbflow", 6)])
def test_epilogue_launches_a_step(config, launches):
    spec = ref.Spec.from_dict(
        harness.load_cell(f"{config}.train-main").config["reference"])
    got = work.epilogue_bound_ms(spec, 40, backward=True)
    assert got["launches_fwd"] == got["launches_bwd"] == launches
    nets = launches // 3
    assert got["bwd"] == pytest.approx(0.9059 * nets, abs=1e-3 * nets)
    assert work.epilogue_bound_ms(spec, 40, backward=False)["bwd"] == 0.0


def resnet50_tsn_macs(frames: int, size: int, classes: int) -> int:
    """Convolution and fc multiply-adds of one clip-segment by hand: the
    stem at size/2, bottlenecks (stride on the 3x3), the frames halving
    after stages 1-3 (kernel 3, stride 2, padding 1)."""
    side = size // 2
    macs = 7 * 7 * 3 * 64 * side * side * frames
    side //= 2                                   # the 3x3 max-pool
    inplanes, f = 64, frames
    for stage, blocks in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** stage
        for b in range(blocks):
            stride = 2 if stage and not b else 1
            out = side // stride
            macs += inplanes * planes * side * side * f
            macs += 9 * planes * planes * out * out * f
            macs += planes * 4 * planes * out * out * f
            if not b:
                macs += inplanes * planes * 4 * out * out * f
            inplanes, side = planes * 4, out
        if stage < 3 and f > 1:
            f = (f - 1) // 2 + 1
    return macs + 2048 * classes * f


def test_step_flops_count_the_resnet_by_hand():
    spec = ref.Spec.from_dict(
        harness.load_cell("flagship.train-main").config["reference"])
    w = ref.make_weights(ref.param_specs(spec), 0, "meta")
    net = ref.Net({k: v for k, v in w.items() if not ref.is_statistic(k)},
                  {k: v for k, v in w.items() if ref.is_statistic(k)},
                  train=False, prec=ref.Prec(), segments=1, dropout=0.5)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.resnet50(net, "main_net.net_rgb",
                     torch.empty((8, 3, 224, 224), device="meta"), 8, None)
    macs = resnet50_tsn_macs(8, 224, 31)
    assert counter.get_total_flops() == 2 * macs
    # about 14.14 GMAC a clip-segment of 8 frames
    assert macs == pytest.approx(14.14e9, rel=0.01)


def test_train_step_counts_forward_and_backward():
    spec = ref.Spec.from_dict(
        harness.load_cell("flagship.train-main").config["reference"])
    fwd = work.step_flops(spec, "eval", 1, 1)
    main = work.step_flops(spec, "main", 1, 1)
    resnet = 2 * resnet50_tsn_macs(8, 224, 31)
    # the live main net's backward is twice its forward, less the two
    # stems' input gradients, which no one needs; the policy's forward only
    stems = 2 * (7 * 7 * 3 * 64 * 112 * 112 * 8 + 3 * 3 * 32 * 128 * 128)
    sound = 763625600           # the audio MobileNetV2's forward at 256 x 256
    assert main == pytest.approx(fwd + 2 * (resnet + sound) - stems,
                                 rel=1e-5)
