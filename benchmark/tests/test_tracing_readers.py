"""The readers of the program's spans, counters and capture map
(``benchmark/spans.py`` and the metrics that use it) over synthetic trace
events and a synthetic map: replays grouped by their launch's
correlation, None on a count or name that disagrees with the map, copy
and memset nodes run as kernels passed over, host spans clipped to the
stretch, and
the division by units; a program without the registry reads nothing."""

import collections

import pytest

from benchmark import harness, spans
from benchmark.trace import STRETCH, Trace
from adamml_tpu_torch.utils import profiling

TID = 1
MAP = {"k": 2, "nodes": 7, "kernels": 4,
       "labels": [None, "model.bn", "model.bn", None],
       "names": ["conv", "reduce_kernel", "elementwise_kernel", "gemm"],
       "driver_nodes": {"memcpy": 1, "memset": 2}}


class Ctx:
    def __init__(self, kind, trace):
        self.kind, self.trace = kind, trace


def _x(name, cat, ts, dur, tid=TID, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _replay(corr, t0, names=None, driver=()):
    """A cudaGraphLaunch at ``t0`` and its kernels (10 us each; the BN
    kernels 100 us); ``driver``: (place, name) of the driver's kernels
    that a replay runs among them for copy and memset nodes."""
    names = list(names or MAP["names"])
    for at, name in sorted(driver, reverse=True):
        names.insert(at, name)
    ev = [_x("cudaGraphLaunch", "cuda_runtime", t0, 5, correlation=corr)]
    for i, n in enumerate(names):
        ev.append(_x(n, "kernel", t0 + 10 + 200 * i,
                     100 if "_kernel" in n else 10, tid=7,
                     correlation=corr))
    return ev


def _trace(replays, host=(), units=4, stretch_units=2):
    ev = [_x(STRETCH, "user_annotation", 1000, 9000)]
    ev += [_x(n, "user_annotation", ts, dur) for n, ts, dur in host]
    # an eager kernel outside any replay
    ev += [_x("cudaLaunchKernel", "cuda_runtime", 50, 5, correlation=99),
           _x("elementwise_kernel", "kernel", 60, 500, tid=7,
              correlation=99)]
    for r in replays:
        ev += r
    return Trace(ev, units, stretch_units)


@pytest.fixture
def registry(monkeypatch):
    monkeypatch.setattr(profiling, "CAPTURES",
                        collections.deque([{"k": 2}, dict(MAP)]))
    monkeypatch.setattr(profiling, "COUNTERS", {})
    return profiling


def _read(metric, ctx):
    return harness.reader(metric).read(ctx)


def test_replays_group_by_their_launch_correlation(registry):
    t = _trace([_replay(20, 3000), _replay(10, 100)])
    groups = spans.replays(t)
    assert [len(g) for g in groups] == [4, 4]
    assert [g[0]["args"]["correlation"] for g in groups] == [10, 20]
    # BN: two kernels of 100 us a replay, two replays, over 4 units
    bn = _read("bn_ms_per_step.train", Ctx("train", t))
    assert bn == pytest.approx(2 * 2 * 0.1 / 4)
    assert _read("launches_per_step.train", Ctx("train", t)) == 2.0


def test_copies_and_fills_run_as_kernels_are_passed_over(registry):
    """Up to as many driver kernels as the map has copy and memset nodes,
    wherever they run among the replay's kernels; one more reads
    nothing."""
    driver = [(2, "memcpy32_post"), (0, "memset32"), (4, "memset32")]
    t = _trace([_replay(10, 100, driver=driver), _replay(20, 3000)])
    got = spans.labelled_replays(t)
    assert [lb for _, lb in got[0]] == MAP["labels"]
    assert _read("bn_ms_per_step.train", Ctx("train", t)) == \
        pytest.approx(0.1)
    assert _read("launches_per_step.train", Ctx("train", t)) == 2.0
    extra = driver + [(1, "memcpy32_post")]
    t = _trace([_replay(10, 100, driver=extra), _replay(20, 3000)])
    assert _read("bn_ms_per_step.train", Ctx("train", t)) is None
    assert _read("launches_per_step.train", Ctx("train", t)) is None


def test_a_count_that_disagrees_reads_nothing(registry):
    short = _replay(20, 3000)[:-1]
    t = _trace([_replay(10, 100), short])
    assert spans.labelled_replays(t) is None
    assert _read("bn_ms_per_step.train", Ctx("train", t)) is None
    assert _read("launches_per_step.train", Ctx("train", t)) is None
    extra = _replay(20, 3000, names=MAP["names"] + ["gemm"])
    t = _trace([_replay(10, 100), extra])
    assert _read("launches_per_step.train", Ctx("train", t)) is None


def test_a_name_that_disagrees_reads_nothing_for_bn(registry):
    other = ["conv", "reduce_kernel", "other_kernel", "gemm"]
    t = _trace([_replay(10, 100), _replay(20, 3000, names=other)])
    assert _read("bn_ms_per_step.train", Ctx("train", t)) is None
    # the launch count compares counts alone
    assert _read("launches_per_step.train", Ctx("train", t)) == 2.0


def test_bn_reads_nothing_unless_the_profile_holds_whole_replays(registry):
    t = _trace([_replay(10, 100), _replay(20, 3000)], units=6)
    assert _read("bn_ms_per_step.train", Ctx("train", t)) is None


def test_host_spans_start_inside_the_stretch_over_its_units(registry):
    host = [("step.stage", 500, 600),     # starts before the stretch
            ("step.stage", 2000, 300),
            ("step.stage", 9900, 400),    # starts inside, ends after
            ("step.stage", 10500, 100),   # after the stretch
            ("step.replay", 2400, 50),
            ("data.h2d", 1500, 80), ("data.h2d", 1600, 20)]
    t = _trace([], host=host, stretch_units=2)
    ctx = Ctx("train", t)
    assert _read("stage_host_ms_per_step.train", ctx) == \
        pytest.approx((0.3 + 0.4) / 2)
    assert _read("replay_host_ms_per_step.train", ctx) == \
        pytest.approx(0.05 / 2)
    assert _read("h2d_host_ms_per_step.train", ctx) == pytest.approx(0.05)
    assert _read("h2d_host_ms_per_request.serve", Ctx("serve", t)) == \
        pytest.approx(0.05)
    # the other kind of cell, or no span: nothing
    assert _read("h2d_host_ms_per_request.serve", ctx) is None
    assert _read("stage_host_ms_per_step.train", Ctx("serve", t)) is None
    bare = Ctx("train", _trace([]))
    assert _read("stage_host_ms_per_step.train", bare) is None


def test_collate_reads_the_counter(registry):
    ctx = Ctx("train", None)
    assert _read("collate_ms_per_batch.train", ctx) is None
    profiling.count("data.collate", 0.2)
    profiling.count("data.collate", 0.4)
    assert _read("collate_ms_per_batch.train", ctx) == pytest.approx(300.0)
    assert _read("collate_ms_per_batch.train", Ctx("serve", None)) is None


def test_a_program_without_the_registry_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "profiling", lambda: None)
    t = _trace([_replay(10, 100), _replay(20, 3000)],
               host=[("step.stage", 2000, 300)])
    for metric in ("bn_ms_per_step.train", "launches_per_step.train",
                   "collate_ms_per_batch.train"):
        assert _read(metric, Ctx("train", t)) is None
    # host spans come from the trace alone: a program without them has
    # none there
    assert _read("stage_host_ms_per_step.train", Ctx("train", t)) == \
        pytest.approx(0.15)
