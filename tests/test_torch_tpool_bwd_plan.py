"""The backward epilogue kernel's launch plan
(``ops/kernels/tpool_fused.py::bwd_plan``), checked on the CPU: the CUDA
kernel (``csrc/tpool_fused_bwd.cu``) walks exactly this plan, and runs only
on a card.

At the three flagship stage boundaries and every ``chip_smoke.BWD_CASES``
shape (the card's checks), in the case's dtype:

  * every (row, frame, pixel, channel group) is written by exactly one
    (block, thread, step) of the kernel's walk (a group is the plan's 16
    bytes: 8 channels in bf16, 4 in float32);
  * the blocks number at least 132 at the flagship stages, and their last,
    ragged wave leaves at most a quarter of the launch's block slots
    empty; fewer than 4 rounds of resident blocks only where no more
    chunks (the partials' limit, 3 pixels a lane) or slice groups exist;
  * the partials, written and read, stay within 2% of the bytes the bound
    counts (``benchmark/reference/work.py::tpool_bwd_work``);
  * a block's shared memory stays under the card's 227 KB, and two blocks
    fit on an SM;
  * the order in which a channel's terms are added does not depend on C.

The planned sum order, emulated on the CPU (``planned_row_sums``: each
pixel lane over its pixels and frames, the 8-lane shuffle tree, the chunks
in order; the card holds the kernel's rows to it bit for bit), gives
``reference_bwd``'s (da, db) within 1e-4 of their largest entry, and the
same bits for the channel block [C/2, C) as for those channels of the
full-C plan.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from adamml_tpu_torch.ops.kernels import tpool_fused as tp
from adamml_tpu_torch.tools import bench_tpool_bwd
from benchmark.reference.work import tpool_bwd_work

from torch_parity import one_torch_thread  # noqa: F401

SMS = 132
BLOCK_SMEM_MAX = 232448    # shared memory a block can use (227 KB)
SM_SMEM = 233472           # an SM's shared memory (228 KB)
SMEM_RESERVED = 1024       # the card's reservation per block
KERNEL_STATIC_SMEM = 2052  # the kernel's lane exchange and ticket flag

# (label, N, F, H, W, C, R, S, dtype): the card's backward cases, the
# flagship stage boundaries first
CASES = [case[:9] for case in chip_smoke.BWD_CASES]
IDS = [case[0] for case in CASES]
FLAGSHIP = [case for case in CASES if case[0].startswith("stage")]


def _plan(case):
    _, n, f, h, w, c, _, _, dtype, = case
    return tp.bwd_plan(n, f, h, w, c, dtype.itemsize, SMS)


def _walk(plan, n, f, hw, c):
    """The kernel's walk, step by step: for each step the (row, pixel,
    group) of every thread with work there and the frames it writes. A
    block is (row, chunk, slice group g); it walks slices g, g + G, ..."""
    lanes, chunks, cp = plan["order"]
    vec, lp = plan["vec"], plan["lane_pixels"]
    g_n, slices = plan["slice_groups"], plan["slices"]
    groups_a_slice = plan["threads"] // lanes
    fo_n = (f - 1) // 2 + 1
    row, chunk, sg, lane, gb = np.meshgrid(
        np.arange(n), np.arange(chunks), np.arange(g_n), np.arange(lanes),
        np.arange(groups_a_slice), indexing="ij")
    end = np.minimum((chunk + 1) * cp, hw)
    for own in range(-(-slices // g_n)):
        sl = sg + own * g_n
        cg = sl * groups_a_slice + gb
        for j in range(lp):
            px = chunk * cp + lane + lanes * j
            ok = (px < end) & (sl < slices) & (cg < c // vec)
            for fo in range(fo_n):
                frames = ([2 * fo - 1] if fo else []) + [2 * fo]
                if fo == fo_n - 1 and 2 * fo + 1 < f:
                    frames.append(2 * fo + 1)
                yield row[ok], px[ok], cg[ok], frames


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_walk_covers_every_element_once(case):
    _, n, f, h, w, c, *_ = case
    plan = _plan(case)
    cover = np.zeros((n, f, h * w, c // plan["vec"]), np.uint8)
    for row, px, cg, frames in _walk(plan, n, f, h * w, c):
        for fr in frames:
            cover[row, fr, px, cg] += 1   # no index repeats within a step
    assert cover.min() == cover.max() == 1


@pytest.mark.parametrize("case", FLAGSHIP, ids=[c[0] for c in FLAGSHIP])
def test_tool_plans_cover_every_element_once(case):
    """The other plans ``tools/bench_tpool_bwd.py`` times (another chunk
    count, one slice group) cover every element once too, and keep the
    order's lanes."""
    _, n, f, h, w, c, *_ = case
    for plan in bench_tpool_bwd.plans((n, f, h, w, c), SMS).values():
        cover = np.zeros((n, f, h * w, c // plan["vec"]), np.uint8)
        for row, px, cg, frames in _walk(plan, n, f, h * w, c):
            for fr in frames:
                cover[row, fr, px, cg] += 1
        assert cover.min() == cover.max() == 1
        assert plan["order"][0] == plan["lanes"] == 8


def test_bench_tool_needs_a_card():
    """The timing tool measures on the card only: here it raises."""
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_tpool_bwd.main([])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocks_fill_the_card(case):
    _, n, f, h, w, c, *_ = case
    plan = _plan(case)
    resident = SMS * plan["blocks_per_sm"]
    assert plan["blocks"] == n * plan["chunks"] * plan["slice_groups"]
    assert plan["waves"] == math.ceil(plan["blocks"] / resident)
    if case in FLAGSHIP:
        # at least 132 blocks, and the last, ragged wave leaves at most a
        # quarter of the launch's block slots empty
        assert plan["blocks"] >= SMS
        assert plan["blocks"] >= 0.75 * plan["waves"] * resident, plan
    if plan["blocks"] < 4 * resident:
        # fewer than 4 rounds of resident blocks: no more chunks were
        # allowed (the partials' limit, or 3 pixels a lane) and every
        # slice has a group of its own
        fo = (f - 1) // 2 + 1
        most = max(1, min((4 * f + fo) * h * w * case[8].itemsize // 800,
                          -(-h * w // (plan["lanes"] * 3))))
        assert plan["chunks"] == -(-h * w // -(-h * w // most)), plan
        assert plan["slice_groups"] == plan["slices"], plan


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_partials_and_shared_memory(case):
    _, n, f, h, w, c, _, _, dtype = case
    plan = _plan(case)
    work, _ = tpool_bwd_work(n, f, h, w, c, dtype.itemsize)
    assert plan["partials_bytes"] <= work / 50
    if plan["chunks"] > 1:
        assert plan["partials_shape"] == (n, plan["chunks"], 2, c)
        assert plan["partials_bytes"] == 2 * n * plan["chunks"] * 2 * c * 4
        assert plan["tickets"] == n
    else:
        assert plan["partials_shape"] is None and plan["tickets"] == 0
    smem = plan["smem_bytes"] + KERNEL_STATIC_SMEM
    assert smem <= BLOCK_SMEM_MAX
    assert plan["blocks_per_sm"] * (smem + SMEM_RESERVED) <= SM_SMEM
    assert plan["smem_bytes"] == (plan["stages"] * 5 * plan["threads"]
                                  * 16)
    assert plan["kernels"] == 1


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sum_order_does_not_depend_on_c(case):
    _, n, f, h, w, c, _, _, dtype = case
    orders = {tp.bwd_plan(n, f, h, w, cc, dtype.itemsize, SMS)["order"]
              for cc in (8, 64, c // 2 // 8 * 8 or 8, c, 2 * c, 2048)}
    assert len(orders) == 1, orders


def _inputs(case, seed):
    label, n, f, h, w, c, r, s, dtype = case
    rs = np.random.RandomState(seed)
    if label == "ties":
        frame = np.abs(rs.randn(n, 1, h, w, c)) + 0.5
        y = torch.from_numpy(np.repeat(frame, f, axis=1)).float().to(dtype)
        ident = torch.zeros_like(y)
        a, b = torch.ones((r, s, c)), torch.zeros((r, s, c))
    else:
        y = torch.from_numpy(rs.randn(n, f, h, w, c)).float().to(dtype)
        ident = torch.from_numpy(rs.randn(n, f, h, w, c)).float().to(dtype)
        a = torch.from_numpy(1.0 + 0.3 * rs.randn(r, s, c)).float()
        b = torch.from_numpy(0.1 * rs.randn(r, s, c)).float()
    ct = torch.from_numpy(rs.randn(n, (f - 1) // 2 + 1, h, w, c)).float()
    return y, ident, a, b, ct.to(dtype)


# the cases small enough to emulate here, and the card's tie case
EMULATED = [case for case in CASES if case not in FLAGSHIP] + [
    ("ties", 2, 4, 8, 8, 8, 1, 1, torch.bfloat16)]


@pytest.mark.parametrize("case", EMULATED, ids=[c[0] for c in EMULATED])
def test_planned_order_gives_reference_sums(case):
    _, n, f, h, w, c, r, s, dtype = case
    y, ident, a, b, ct = _inputs(case, seed=3)
    plan = tp.bwd_plan(n, f, h, w, c, dtype.itemsize, SMS)
    dab = tp.planned_row_sums(tp.routed_dpre(y, ident, a, b, ct), y, plan)
    got = tp._group_sums(dab, r, s)
    want = tp.reference_bwd(y, ident, a, b, ct)[2:]
    for g, w_ in zip(got, want):
        assert float((g - w_).abs().max()) <= 1e-4 * float(w_.abs().max())


@pytest.mark.parametrize("case", [c for c in EMULATED if c[5] % 16 == 0],
                         ids=[c[0] for c in EMULATED if c[5] % 16 == 0])
def test_channel_block_sums_are_bit_identical(case):
    """The upper channel block [C/2, C), made contiguous as the model's
    shard is, planned for its own C: the same bits as those channels of
    the full-C plan."""
    _, n, f, h, w, c, r, s, dtype = case
    y, ident, a, b, ct = _inputs(case, seed=4)
    dpre = tp.routed_dpre(y, ident, a, b, ct)
    full = tp.planned_row_sums(dpre, y, tp.bwd_plan(n, f, h, w, c, dtype.itemsize,
                                              SMS))
    lo = c // 2
    block = tp.planned_row_sums(dpre[..., lo:].contiguous(),
                          y[..., lo:].contiguous(),
                          tp.bwd_plan(n, f, h, w, c - lo, dtype.itemsize,
                                      SMS))
    assert torch.equal(block, full[..., lo:])


def test_ptxas_entries_read_the_build_log(monkeypatch):
    """``build.ptxas_entries`` reads each instantiation's registers, shared
    memory and spills from ``-Xptxas -v`` output (the card's checks hold
    the backward kernel's to 0 spill bytes)."""
    from adamml_tpu_torch.ops.kernels import build

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelI13__nv_bfloat16EvPv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelI13__nv_bfloat16EvPv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 2064 bytes smem, 536 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelIfEvPv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelIfEvPv
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 106 registers, used 1 barriers, 536 bytes cmem[0]
"""
    monkeypatch.setattr(build, "build_log", lambda name: log)
    assert build.ptxas_entries("tpool_fused_bwd") == [
        {"entry": "_Z6kernelI13__nv_bfloat16EvPv", "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 128,
         "smem": 2064},
        {"entry": "_Z6kernelIfEvPv", "stack": 8, "spill_stores": 12,
         "spill_loads": 4, "registers": 106, "smem": 0}]
