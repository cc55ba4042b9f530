"""The port's spans, counters and capture map (``utils/profiling.py``) on
the CPU: spans cost nothing without a profiler; the pinned-copy spans of a
preprocessing and the loader's collate counter; the capture map assembled
from span boundaries that a stub node counter gives; the BN markers, forced
on by a capture map with stub counters, leave forward outputs and
gradients bit-equal; ``StepProfiler`` over whole dispatches, with the
counters and maps written beside its trace. The card's side (a real
capture, its kernel nodes against a replay's trace) is in
``tests/test_torch_gpu.py``."""

import glob
import json

import numpy as np
import pytest
import torch

from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.configs.config import arg_parser, config_from_args
from adamml_tpu_torch.data.dataflow import HostDataLoader
from adamml_tpu_torch.data.device_pipeline import make_batch_preprocessor
from adamml_tpu_torch.data.synthetic import SyntheticVideoDataset
from adamml_tpu_torch.models.model_builder import build_model, example_inputs
from adamml_tpu_torch.models.norm import GroupedBatchNorm
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.steps import make_adamml_train_step
from adamml_tpu_torch.train.train_state import StageFlags, TrainState
from adamml_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _stub_capture(k=1):
    """A capture map of a capture that never moves: the markers go in, no
    graph is needed."""
    return profiling.capture_map(k, mark=lambda: (),
                                 nodes=lambda: ([], [], None))


def test_span_is_a_no_op_without_a_profiler():
    """No profiler, no capture: the one shared object, whatever the name;
    a profiler running: a span of its own, which it records."""
    assert profiling.span("a") is profiling.span("b") is profiling._OFF
    with profiling.span("a") as got:
        assert got is None
    with _cpu_profile():
        assert profiling.span("a") is not profiling._OFF
    assert profiling.span("a") is profiling._OFF


def _loader(batches=3, batch=4):
    ds = SyntheticVideoDataset(("rgb", "sound"), length=batches * batch,
                               num_groups=2, frames_per_group=2, num_clips=2,
                               num_classes=7, canvas_size=(20, 24),
                               audio_length=0.02, is_train=True,
                               dense_sampling=True, seed=3)
    return HostDataLoader(ds, batch, is_train=True, input_size=16,
                          scale_range=(20, 28), workers=2, seed=5)


def test_h2d_spans_of_a_preprocessing(tmp_path):
    """Under a CPU profiler each host array a preprocessing moves (rgb
    frames, crop, flip; the waveforms and their mask; the target) lies in
    one ``data.h2d`` span."""
    argv = ["--dataset", "synthetic", "--modality", "rgb", "sound",
            "--groups", "2", "--frames_per_group", "2", "--dense_sampling",
            "--num_segments", "2", "--input_size", "16", "--audio_length",
            "0.02", "--compute_dtype", "float32", "--scale_range", "20", "28"]
    cfg = config_from_args(arg_parser().parse_args(argv))
    pre = make_batch_preprocessor(cfg, train=True, num_segments=2,
                                  device="cpu")
    batch = next(iter(_loader()))
    with _cpu_profile() as prof:
        inputs, target = pre(batch)
    spans = [e for e in _events(prof, tmp_path) if e["name"] == "data.h2d"]
    assert len(spans) == 6
    assert all(e["cat"] == "user_annotation" for e in spans)
    assert target.shape == (4,) and len(inputs) == 2


def test_collate_counter_counts_each_batch(tmp_path):
    """``data.collate`` counts one event a batch, with its seconds; where
    the profiler records the producer thread, its spans are in the trace,
    one a batch."""
    before = profiling.counters().get("data.collate",
                                      {"count": 0, "seconds": 0.0})
    with _cpu_profile() as prof:
        got = list(_loader(batches=3))
    after = profiling.counters()["data.collate"]
    assert len(got) == 3
    assert after["count"] - before["count"] == 3
    assert after["seconds"] > before["seconds"]
    spans = [e for e in _events(prof, tmp_path)
             if e["name"] == "data.collate"]
    assert len(spans) in (0, 3)


class _Graph:
    """A stub capture: ``launch(n, kind)`` adds nodes of a CUgraphNodeType,
    their handles their indices; ``mark`` gives the last node captured."""

    def __init__(self):
        self.kinds = []

    def launch(self, n=1, kind=profiling.KERNEL_NODE):
        self.kinds += [kind] * n

    def mark(self):
        return (len(self.kinds) - 1,) if self.kinds else ()

    def nodes(self):
        kernels = self.kinds.count(profiling.KERNEL_NODE)
        return (list(range(len(self.kinds))), list(self.kinds),
                [f"k{i}" for i in range(kernels)])

    def capture_map(self, k=1, mark=None):
        return profiling.capture_map(k, mark=mark or self.mark,
                                     nodes=self.nodes)


def test_capture_map_from_stub_boundaries():
    """Nodes before the map opened are not the capture's; each node takes
    the innermost span that holds it (nested spans, a span of no node, a
    span reopened); memcpy and memset nodes are counted apart, other
    nodes dropped; the map is kept in ``CAPTURES``."""
    g = _Graph()
    g.launch(2)                                  # before the capture
    with g.capture_map(2) as cmap:
        g.launch(1)                              # 0: no span
        with profiling.span("outer"):
            g.launch(2)                          # 1, 2: outer
            with profiling.span("inner"):
                g.launch(1)                      # 3: inner
                g.launch(1, kind=profiling.MEMSET_NODE)
                with profiling.span("empty"):
                    pass
            g.launch(1)                          # 4: outer
            g.launch(1, kind=profiling.MEMCPY_NODE)
            with profiling.span("inner"):
                g.launch(1)                      # 5: inner
        g.launch(1)                              # 6: no span
        g.launch(1, kind=profiling.MEMCPY_NODE)
        g.launch(1, kind=5)                      # an empty node
    res = cmap.result
    assert profiling.CAPTURES[-1] is res
    assert (res["k"], res["nodes"], res["kernels"]) == (2, 11, 7)
    assert res["labels"] == [None, "outer", "outer", "inner", "outer",
                             "inner", None]
    assert res["names"] == [f"k{i + 2}" for i in range(7)]
    assert res["driver_nodes"] == {"memcpy": 2, "memset": 1}
    assert profiling._capture is None
    assert profiling.span("x") is profiling._OFF


def test_capture_map_refuses_spans_left_open():
    g = _Graph()
    with pytest.raises(RuntimeError, match="left open"):
        with g.capture_map() as cmap:
            cmap.open("model.bn")
    assert profiling._capture is None


@pytest.mark.parametrize("return_affine", [False, True],
                         ids=["affine", "return_affine"])
def test_bn_markers_leave_outputs_and_gradients_bit_equal(return_affine):
    """A train-mode BN with its backward markers in (a capture map of stub
    counters) against the same BN without: the outputs and the gradients
    of the input, scale and bias are equal bit for bit, and the backward
    opens and closes the span once."""
    torch.manual_seed(0)
    x0 = torch.randn(8, 3, 3, 16)
    cot = [torch.randn(8, 3, 3, 16), torch.randn(2, 2, 16),
           torch.randn(2, 2, 16)]
    got = []
    for markers in (False, True):
        bn = GroupedBatchNorm(16, groups=2)
        with torch.no_grad():
            bn.weight.copy_(1 + 0.1 * torch.arange(16.0))
            bn.bias.copy_(0.01 * torch.arange(16.0))
        x = x0.clone().requires_grad_(True)
        opened = []
        with (_stub_capture() if markers else _NoCapture()) as cmap:
            if markers:
                cmap.open = lambda name, f=cmap.open: (opened.append(name),
                                                       f(name))
            out = bn(x, True, return_affine, 2, 1)
            outs = out if return_affine else (out,)
            loss = sum((o * c).sum() for o, c in
                       zip(outs, cot[1:] if return_affine else cot))
            loss.backward()
            assert not markers or not cmap.stack
        got.append([o.detach() for o in outs]
                   + [x.grad, bn.weight.grad, bn.bias.grad])
        # the forward's span, then the backward's
        assert opened == (["model.bn"] * 2 if markers else [])
    for a, b in zip(*got):
        assert torch.equal(a, b)


class _NoCapture:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_bn_backward_span_brackets_its_nodes():
    """The backward part of ``model.bn`` holds exactly the nodes launched
    between the gradient of its output arriving and the gradient of its
    input leaving: a stub graph gains a node at each autograd node that
    runs (a hook on every node of the loss's graph), and the span opened
    by the marker on the output closes after the node of the input's
    cast."""
    g = _Graph()
    bn = GroupedBatchNorm(4)
    x = torch.randn(6, 4, requires_grad=True)
    w = torch.randn(6, 4)
    with g.capture_map() as cmap:
        y = bn(x * 2, True)
        loss = (y * w).sum()
        seen, stack = set(), [loss.grad_fn]
        while stack:
            fn = stack.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            fn.register_prehook(lambda *a: g.launch(1))
            stack += [nxt for nxt, _ in fn.next_functions]
        loss.backward()
    labels = cmap.result["labels"]
    # the loss's sum and mul and the output marker's own hook before the
    # span; BN's one node (ops/kernels/bn_train.py), its parameters' two
    # accumulations and the input marker's hook inside; the input's mul and
    # accumulation after it
    inside = labels.count("model.bn")
    assert inside == 4
    assert labels == [None] * 3 + ["model.bn"] * inside + [None] * 2


@pytest.mark.parametrize("phase", ["main", "policy"])
def test_train_step_with_markers_is_bit_equal(phase):
    """One tiny train step of each phase (the policy phase rematerializes
    the trunks) with every BN's markers in, against the same step without:
    the parameters, BN statistics and metrics are equal bit for bit, and
    every span the markers opened was closed."""
    cfg = flagship_cfg(tiny=True)
    got = []
    for markers in (False, True):
        torch.manual_seed(0)
        model, _ = build_model(cfg, "cpu")
        state = TrainState(
            build_optimizer("main", cfg.optim, model.main_net.parameters()),
            build_optimizer("policy", cfg.optim,
                            model.policy_net.parameters()))
        step = make_adamml_train_step(
            model, flags=(StageFlags.main_phase() if phase == "main"
                          else StageFlags.policy_phase()),
            penalty_type="blockdrop", gammas=10.0, clip_gradient=None)
        inputs = example_inputs(cfg, batch=4, seed=7, device="cpu")
        target = torch.arange(4) % 5
        with (_stub_capture() if markers else _NoCapture()):
            metrics = step(state, inputs, target, 1e-3, 1e-2, [1.0, 0.05],
                           3)
        got.append((model.state_dict(), metrics))
    (sd0, m0), (sd1, m1) = got
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k


def test_step_profiler_holds_whole_dispatches_and_writes_spans(tmp_path):
    """With K = 2 the profile holds loader indices [4, 8): dispatches 2
    and 3, after the eager dispatch and the capture; beside the trace, the
    counters and the capture maps as JSON."""
    prof = profiling.StepProfiler(str(tmp_path), num_steps=3,
                                  steps_per_dispatch=2)
    assert (prof.start_step, prof.stop_step) == (4, 8)
    profiling.count("test.event", 0.5)
    x = torch.ones(4)
    for i in range(10):
        prof.step(i)
        with torch.profiler.record_function(f"step_{i}"):
            x = x * 2
    prof.close()
    with open(prof.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {f"step_{i}" for i in range(4, 8)} <= names
    assert not names & {f"step_{i}" for i in (0, 1, 2, 3, 8, 9)}
    assert sorted(glob.glob(str(tmp_path / "*"))) == sorted(
        [prof.path, prof.spans_path])
    with open(prof.spans_path) as f:
        spans = json.load(f)
    assert spans["counters"]["test.event"]["count"] >= 1
    assert isinstance(spans["captures"], list)
    one = profiling.StepProfiler(str(tmp_path), steps_per_dispatch=1)
    assert (one.start_step, one.stop_step) == (2, 5)
    assert np.isfinite(spans["counters"]["test.event"]["seconds"])


def test_capture_map_ignores_other_threads():
    """A loader's thread that collates while a graph is captured neither
    counts the graph's nodes nor records a span in its map; its counter
    still counts."""
    import threading

    g = _Graph()
    callers = []

    def mark():
        callers.append(threading.get_ident())
        return g.mark()

    before = profiling.counters().get("test.thread", {"count": 0})["count"]
    with g.capture_map(mark=mark) as cmap:
        def collate():
            with profiling.counted("test.thread"):
                g.launch(1)

        t = threading.Thread(target=collate)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with profiling.span("main"):
            g.launch(1)
    assert set(callers) == {threading.get_ident()}
    assert cmap.result["labels"] == [None, "main"]
    assert profiling.counters()["test.thread"]["count"] == before + 1


def test_kernel_names_demangle_as_the_profiler_writes_them():
    """The capture map names a kernel as a trace does: a C++ symbol
    demangled, a C name as it is."""
    demangle = profiling._Demangler()
    assert demangle(b"_Z3fooi") == "foo(int)"
    assert demangle(b"tpool_fused_fwd") == "tpool_fused_fwd"
