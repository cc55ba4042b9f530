"""The card's crop-resize kernel (``ops/kernels/crop_resize.py``,
``csrc/crop_resize.cu``) on the CPU: what can be checked without a card.

The kernel's tap rule (``axis_taps``: each output's candidates, its band of
nonzero weights and their total, in the kernel's float32 operations) gives
back ``augment.resample_weights``' dense matrix over minifying (16 and 116
taps), magnifying, edge-crossing, outside-the-canvas, sub-pixel, negative
and empty crops (``tools/crop_cases.py::AXIS_CASES``): the same nonzero
entries, the weights equal to float32 rounding (the total is summed in
another order); the card tests hold the kernel's own weights to
``band_weights`` bit for bit. The plain path's packing, rgbdiff and
oversample crops equal the composition the preprocessor made before the
kernel. The launch plan, the byte count of the bound, the wrapper's
refusals, and a CPU tensor taking the plain path with no launch. The
kernel itself runs in ``tests/test_torch_gpu.py`` (``-k crop_resize``).
"""

import pytest
import torch

from adamml_tpu_torch.ops import augment
from adamml_tpu_torch.ops.kernels import crop_resize as crk
from adamml_tpu_torch.tools import crop_cases as cc
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)


def _axis(case):
    in_size, out_size, origin, extent = cc.AXIS_CASES[case]
    return (in_size, out_size, torch.tensor([origin]),
            torch.tensor([extent]))


@pytest.mark.parametrize("case", sorted(cc.AXIS_CASES))
def test_band_weights_are_resample_weights(case):
    """The kernel's weights equal the plain path's dense matrix: the same
    nonzero entries, the same values to float32 rounding (the dense total
    adds every canvas index, the kernel its candidates in order: at most
    one rounding a term apart)."""
    in_size, out_size, origin, extent = _axis(case)
    scale = out_size / extent
    want = augment.resample_weights(in_size, out_size, scale,
                                    -origin * scale)
    got = crk.band_weights(in_size, out_size, origin, extent)
    assert got.shape == want.shape == (1, out_size, in_size)
    assert torch.equal(got != 0, want != 0)
    torch.testing.assert_close(got, want, rtol=8e-6, atol=0)


@pytest.mark.parametrize("case", sorted(cc.AXIS_CASES))
def test_band_lies_within_the_candidates(case):
    """Each output's band is contiguous, inside its candidates and the
    canvas; an output with no band reads 0 from every canvas index."""
    in_size, out_size, origin, extent = _axis(case)
    t = crk.axis_taps(in_size, out_size, origin, extent)
    used = t["count"] > 0
    lo, hi = t["lo"], t["lo"] + t["count"] - 1
    assert bool((lo[used] >= t["first"][used]).all())
    assert bool((hi[used] <= t["last"][used]).all())
    assert bool((hi[used] < in_size).all()) and bool((lo >= 0).all())
    w = crk.band_weights(in_size, out_size, origin, extent)
    assert torch.equal((w != 0).sum(-1), t["count"])
    assert bool((w[~used] == 0).all())


def test_tap_counts_of_the_named_cases():
    """The nonzero taps a kernel thread walks: 16 at 64 -> 8 (of 19
    candidates), 116 at 464 -> 8, at most 2 when magnifying, 1 at scale 1
    on whole pixels, none off the canvas or for an empty crop."""
    def counts(case):
        return crk.axis_taps(*_axis(case))["count"][0]
    assert int(counts("minify_8x").max()) == 16
    assert int(counts("minify_58x").max()) == 116
    for case in ("train_crop", "magnify", "sub_pixel_3p5"):
        assert int(counts(case).max()) == 2, case
    assert bool((counts("eval_centre") == 1).all())
    for case in ("outside_right", "outside_left", "empty"):
        assert int(counts(case).max()) == 0, case


def _batch(modality, ncrops, seed=0):
    a = cc.odd_inputs(modality, ncrops, 16, True, "cpu", seed)
    return a["frames"], a["crop_xywh"], a["flip"]


@pytest.mark.parametrize("modality", sorted(cc.MODALITIES))
def test_plain_path_packs_as_the_preprocessor_did(modality):
    """plain_crop_resize with cons, rgbdiff and oversample crops equals the
    composition make_batch_preprocessor ran before the kernel: canvases
    repeated per crop, rgbdiff_from_frames over groups of six, the resize
    frame by frame, then (N, S*F*cons, h, w, c) -> (N, S*F, h, w, cons*c);
    bit for bit."""
    c, cons, rgbdiff, flow = cc.MODALITIES[modality]
    ncrops = 2
    frames, crop, flip = _batch(modality, ncrops, seed=3)
    kw = dict(out_size=16, mean=(0.5,) * c, std=(0.25,) * c,
              flow_channels=flow, compute_dtype=torch.bfloat16)
    got = augment.plain_crop_resize(frames, crop, flip, cons=cons,
                                    rgbdiff=rgbdiff, ncrops=ncrops, **kw)
    x = frames.repeat_interleave(ncrops, dim=0)
    n = x.shape[0]
    if rgbdiff:
        p = x.shape[1] // 6
        x = augment.rgbdiff_from_frames(
            x.reshape((n, p, 6) + tuple(x.shape[2:])))
        x = x.reshape((n, p * 5) + tuple(x.shape[3:]))
    out = augment.plain_crop_resize(x, crop, flip, **kw)
    t = out.shape[1] // cons
    out = out.reshape(n, t, cons, 16, 16, c).permute(0, 1, 3, 4, 2, 5)
    assert torch.equal(got, out.reshape(n, t, 16, 16, cons * c))


def test_cpu_tensors_take_the_plain_path():
    frames, crop, flip = _batch("rgbdiff", 1)
    before = dict(crk.launch_counts)
    kw = dict(out_size=8, mean=None, std=None, cons=5, rgbdiff=True)
    got = augment.crop_resize_normalize(frames, crop, flip, **kw)
    assert torch.equal(got, augment.plain_crop_resize(frames, crop, flip,
                                                      **kw))
    assert crk.launch_counts == before


@pytest.mark.parametrize("out_size", [8, 48, 224])
@pytest.mark.parametrize("channels", [3, 10, 15])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_covers_every_row_within_shared_memory(out_size, channels,
                                                    itemsize):
    pl = crk.plan(out_size, out_size, channels, itemsize)
    row_bytes = out_size * channels * itemsize
    assert 1 <= pl["rows"] <= crk.MAX_ROWS
    assert pl["rows"] * row_bytes <= crk.STAGE_BYTES or pl["rows"] == 1
    assert (pl["tiles"] - 1) * pl["rows"] < out_size <= (
        pl["tiles"] * pl["rows"])
    assert pl["stage"] % 16 == 0
    assert 0 <= pl["stage"] - pl["rows"] * row_bytes < 16
    assert pl["smem"] == pl["stage"] + (out_size + pl["rows"]) * crk.TAP_BYTES
    assert pl["smem"] <= 48 * 1024


def test_work_counts_the_support_and_the_output():
    """At scale 1 on whole pixels each output reads one canvas pixel: the
    support is the crop itself, in every canvas frame."""
    crop = torch.tensor([[8.0, 4.0, 16.0, 16.0], [0.0, 0.0, 16.0, 16.0]])
    got = crk.work((2, 12, 40, 64, 3), crop, 16, cons=5, rgbdiff=True,
                   itemsize=2)
    assert got == 2 * 16 * 16 * 12 * 3 + 2 * 2 * 16 * 16 * 15 * 2
    half = torch.tensor([[0.0, 0.0, 32.0, 32.0]])  # minified 2:1, 2x2 taps
    got = crk.work((1, 1, 40, 64, 3), half, 16, cons=1, rgbdiff=False,
                   itemsize=4)
    t = crk.axis_taps(64, 16, half[:, 0], half[:, 2])
    side = int(t["lo"][0, -1] + t["count"][0, -1] - t["lo"][0, 0])
    assert got == side * side * 3 + 16 * 16 * 3 * 4


CROPS = torch.tensor(cc.ODD_CROPS)
FLIPS = torch.tensor(cc.ODD_FLIPS)


def _ok():
    frames, crop, flip = _batch("rgb", 1)
    return dict(frames=frames, crop_xywh=crop, flip=flip, out_size=8,
                mean=(0.5,) * 3, std=(0.25,) * 3)


REFUSALS = {
    "float_frames": (dict(frames=torch.zeros(9, 2, 40, 64, 3)), "uint8"),
    "four_dims": (dict(frames=torch.zeros(9, 40, 64, 3, dtype=torch.uint8)),
                  "uint8"),
    "crop_float64": (dict(crop_xywh=CROPS.double()), "float32"),
    "crop_shape": (dict(crop_xywh=CROPS[:4]), "float32"),
    "flip_uint8": (dict(flip=FLIPS.to(torch.uint8)), "bool"),
    "four_channels": (dict(frames=torch.zeros(9, 2, 40, 64, 4,
                                              dtype=torch.uint8),
                           mean=None, std=None), "must be one of"),
    "cons_3": (dict(cons=3), "must be one of"),
    "rgb_stacked": (dict(frames=torch.zeros(9, 5, 40, 64, 3,
                                            dtype=torch.uint8), cons=5),
                    "must be one of"),
    "flow_unstacked": (dict(frames=torch.zeros(9, 2, 40, 64, 2,
                                               dtype=torch.uint8),
                            mean=None, std=None), "must be one of"),
    "rgbdiff_unstacked": (dict(rgbdiff=True), "must be one of"),
    "rgbdiff_groups": (dict(cons=5, rgbdiff=True), "groups of 6"),
    "float16_out": (dict(out_dtype=torch.float16), "out_dtype"),
    "mean_without_std": (dict(std=None), "mean and std"),
    "strided_frames": (dict(frames=torch.zeros(
        9, 2, 40, 128, 3, dtype=torch.uint8)[:, :, :, ::2]), "contiguous"),
    "on_the_cpu": ({}, "one card"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Each refusal raises before any launch (the CPU cases here; a tensor
    on the CPU beside one on the card: tests/test_torch_gpu.py)."""
    kw, match = REFUSALS[case]
    args = dict(_ok(), **kw)
    with pytest.raises(ValueError, match=match):
        crk.crop_resize(args.pop("frames"), args.pop("crop_xywh"),
                        args.pop("flip"), **args)
