"""The depthwise kernel's tiling (``ops/kernels/depthwise.py::tile_plan``
and ``tile_windows``), checked on the CPU: the CUDA kernel computes its
tiles' geometry the same way, and runs only on a card.

At the 20 distinct (shape, stride) pairs of one flagship eval step with
``use_pallas_dw=True``, at odd sizes (9x11, 7x5, one row, one column) and at
C = 8, 12, 24 and 960, in bf16 and float32:

  * every output pixel and channel of an image is covered by exactly one
    tile;
  * each tile's staged input window is exactly the rows and columns its
    taps read under XLA's SAME pads (``adamml_tpu``'s ``_same_pads``),
    including the (0, 1) split at stride 2 on an even size;
  * a block's shared memory stays within the card's 232,448 bytes and its
    threads within the kernel's launch bounds;
  * at the small sizes, a tile-by-tile emulation in PyTorch (each tile's
    outputs computed from its zero-filled window alone) equals
    ``reference_impl`` bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adamml_tpu.ops.pallas import depthwise as jdw
from adamml_tpu_torch.ops.kernels import depthwise as tdw

from torch_parity import one_torch_thread  # noqa: F401

# the 20 (x shape, stride) pairs of one 8-clip flagship eval step: the rgb
# policy trunk (160 frames at 160x160, pooled in time to 80, then 40), then
# the audio trunk's and backbone's (40 spectrograms at 256x256)
FLAGSHIP = [
    ((160, 80, 80, 32), 1), ((160, 80, 80, 96), 2), ((160, 40, 40, 144), 1),
    ((160, 40, 40, 144), 2), ((160, 20, 20, 192), 1), ((80, 20, 20, 192), 2),
    ((80, 10, 10, 384), 1), ((80, 10, 10, 576), 1), ((40, 10, 10, 576), 2),
    ((40, 5, 5, 960), 1),
    ((40, 128, 128, 32), 1), ((40, 128, 128, 96), 2), ((40, 64, 64, 144), 1),
    ((40, 64, 64, 144), 2), ((40, 32, 32, 192), 1), ((40, 32, 32, 192), 2),
    ((40, 16, 16, 384), 1), ((40, 16, 16, 576), 1), ((40, 16, 16, 576), 2),
    ((40, 8, 8, 960), 1),
]

ODD = [((2, h, w, c), s) for h, w in ((9, 11), (7, 5), (1, 37), (35, 1))
       for c in (8, 12, 24, 960) for s in (1, 2)]


def _ids(cases):
    return ["x".join(map(str, shape)) + f"-s{s}" for shape, s in cases]


def _check_geometry(shape, stride, itemsize):
    b, h, w, c = shape
    p = tdw.tile_plan(b, h, w, c, stride, itemsize)
    oh, pad_t, _ = jdw._same_pads(h, stride)
    ow, pad_l, _ = jdw._same_pads(w, stride)
    assert (p.oh, p.ow) == (oh, ow)
    assert c % p.vec == 0 and p.cb % p.vec == 0 and c % p.cb == 0
    assert 1 <= p.threads <= tdw.MAX_THREADS
    assert p.smem_bytes <= tdw.MAX_SMEM_BYTES
    assert p.grid[1] == c // p.cb and p.grid[2] == b <= 65535
    covered = np.zeros((oh, ow, c), np.int32)
    windows = list(tdw.tile_windows(p))
    assert len(windows) == p.grid[0] * p.grid[1]
    for t in windows:
        covered[t["oy0"]:t["oy1"], t["ox0"]:t["ox1"], t["c0"]:t["c1"]] += 1
        assert t["oy1"] - t["oy0"] <= p.th and t["ox1"] - t["ox0"] <= p.tw
        # the rows and columns the taps of the tile's outputs read
        rows = {o * stride - pad_t + dy for o in range(t["oy0"], t["oy1"])
                for dy in range(3)}
        cols = {o * stride - pad_l + dx for o in range(t["ox0"], t["ox1"])
                for dx in range(3)}
        assert set(range(t["iy0"], t["iy1"])) == rows
        assert set(range(t["ix0"], t["ix1"])) == cols
    assert (covered == 1).all()
    return p


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,stride", FLAGSHIP, ids=_ids(FLAGSHIP))
def test_tile_plan_flagship_layers(shape, stride, itemsize):
    """Coverage, windows and limits at the flagship layers; the large ones
    make at least two tiles for each of the card's 132 SMs."""
    p = _check_geometry(shape, stride, itemsize)
    if shape[1] * shape[2] >= 40 * 40:
        assert p.tiles >= 2 * tdw.NUM_SMS


def _emulate(x, w, p):
    """The kernel's tiles in PyTorch: each fills its window from x (zeros
    outside the image) and computes its outputs from the window alone, in
    the kernel's order of taps."""
    b, h, wd, c = x.shape
    out = torch.full((b, p.oh, p.ow, c), float("nan"))
    xf, taps, s = x.float(), w.float(), p.stride
    for t in tdw.tile_windows(p):
        win = torch.zeros((b, t["iy1"] - t["iy0"], t["ix1"] - t["ix0"],
                           t["c1"] - t["c0"]))
        ys = slice(max(t["iy0"], 0), min(t["iy1"], h))
        xs = slice(max(t["ix0"], 0), min(t["ix1"], wd))
        win[:, ys.start - t["iy0"]:ys.stop - t["iy0"],
            xs.start - t["ix0"]:xs.stop - t["ix0"]] = \
            xf[:, ys, xs, t["c0"]:t["c1"]]
        rows, cols = t["oy1"] - t["oy0"], t["ox1"] - t["ox0"]
        acc = torch.zeros((b, rows, cols, t["c1"] - t["c0"]))
        for dy in range(3):
            for dx in range(3):
                acc = acc + (win[:, dy:dy + s * (rows - 1) + 1:s,
                                 dx:dx + s * (cols - 1) + 1:s]
                             * taps[dy, dx, t["c0"]:t["c1"]])
        out[:, t["oy0"]:t["oy1"], t["ox0"]:t["ox1"], t["c0"]:t["c1"]] = acc
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,stride", ODD, ids=_ids(ODD))
def test_tile_plan_odd_sizes(shape, stride, dtype):
    """Coverage, windows and limits at sizes that cross the tiles' edges,
    and the tile-by-tile emulation bit-equal to ``reference_impl``."""
    p = _check_geometry(shape, stride, torch.finfo(dtype).bits // 8)
    rs = np.random.RandomState(sum(shape) + stride)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rs.randn(3, 3, shape[-1]).astype(np.float32))
    torch.testing.assert_close(
        _emulate(x, w, p), tdw.reference_impl(x, w, None, None, stride,
                                              False), rtol=0, atol=0)


def test_tile_plan_splits_channels_of_small_layers():
    """The small late layers get their tiles from channel slices: at
    (40, 5, 5, 960) a tile takes part of the channels, and the layer makes
    more tiles than the card has SMs."""
    p = tdw.tile_plan(40, 5, 5, 960, 1, 2)
    assert p.cb < 960 and p.tiles > tdw.NUM_SMS


def test_reference_padding_matches_f_pad_of_same():
    """The emulation's zero fill and ``reference_impl``'s F.pad agree at a
    stride-2 even size, where SAME pads (0, 1)."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(1, 6, 6, 8).astype(np.float32))
    w = torch.from_numpy(rs.randn(3, 3, 8).astype(np.float32))
    p = tdw.tile_plan(1, 6, 6, 8, 2, 4)
    assert (p.pad_t, p.pad_l) == (0, 0)
    xp = F.pad(x, (0, 0, 0, 1, 0, 1))
    want = sum(xp[:, dy:dy + 5:2, dx:dx + 5:2] * w[dy, dx]
               for dy in range(3) for dx in range(3))
    torch.testing.assert_close(_emulate(x, w, p), want, rtol=1e-6,
                               atol=1e-6)
