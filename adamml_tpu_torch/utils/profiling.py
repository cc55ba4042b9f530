"""Profiling of the port (``adamml_tpu/utils/profiling.py``) on
``torch.profiler``: spans, counters, the capture map and ``StepProfiler``.

- ``span(name)``: a ``torch.profiler.record_function`` range while a
  profiler runs, so that it lands in the same trace as the card's events
  and on the same clock. With no profiler running and no capture in
  progress it costs one flag check and makes no object.
- ``counted(name)``: a span whose count and seconds also go to ``COUNTERS``
  (name -> [count, seconds]), a process-wide table that is always on (two
  ``perf_counter`` reads an event) and that outlives the objects of a run.
- The capture map: while ``capture_map()`` is open around the capture of a
  CUDA graph, each span that opens and closes records which of the graph's
  nodes were created inside it (it notes the last node that the current
  stream captured, through the driver API, and the graph is walked once
  at the end: no sync, no added node). At the end the map holds one label a kernel node, in the order
  the nodes were created, which in a graph captured on one stream is the
  order a replay runs them: the innermost span, or None. Maps are kept in
  ``CAPTURES``.
- ``spanned`` also spans a module's backward, while a capture is in
  progress or a profiler runs (an eager step in a trace): an identity
  ``autograd.Function`` at each end of the module opens the span when the
  gradient of its outputs arrives and closes it when the gradient of its
  input leaves (after the module's first node, where its input takes no
  gradient). The autograd engine runs the nodes between the two in one
  stretch, highest sequence number first, since nothing outside the
  module consumes what it makes inside. In a trace the backward's range
  lies on the thread that runs it: the autograd engine's, for a card.
  Tensors the call takes after x (MViT's ``model.attn``: q, then k and v)
  carry no marker: the span closes when x's gradient leaves, after the
  nodes that also give theirs. The models' spans: SlowFast's
  ``model.slow``, ``model.fast``, ``model.fuse``; MViT's ``model.pool``,
  ``model.attn``, ``model.mlp``.
- ``StepProfiler``: with --profile_dir set, the curriculum hands the engine
  one for the first epoch of each training pass; it traces steps [start,
  stop) of it (loader indices; with K steps a dispatch, whole dispatches
  after the one that captures the graph), the host's and, when a card is
  present, the card's activity, and writes the directory a Chrome trace
  (``*.pt.trace.json``, readable by Perfetto or chrome://tracing) and, beside
  it, the counters and capture maps (``*.spans.json``).
"""

from __future__ import annotations

import collections
import ctypes
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

COUNTERS: Dict[str, List[float]] = {}
CAPTURES: "collections.deque[dict]" = collections.deque(maxlen=16)
_COUNTERS_LOCK = threading.Lock()
_capture: Optional["CaptureMap"] = None


class _Off:
    """The span of an untraced, uncaptured run: nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rf", "cap")

    def __init__(self, name: str, cap: Optional["CaptureMap"]):
        self.name, self.rf, self.cap = name, None, cap

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.cap is not None:
            self.cap.open(self.name)
        return None

    def __exit__(self, *exc):
        if self.cap is not None:
            self.cap.close()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _capturing() -> Optional["CaptureMap"]:
    """The capture map open in this thread's capture, or None."""
    cap = _capture
    return cap if cap is not None and cap.here() else None


def span(name: str):
    """A named range of the program's host work (``with span(...):``)."""
    if _capture is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, _capturing())


def count(name: str, seconds: float) -> None:
    """One event of ``name`` that took ``seconds``, in ``COUNTERS``."""
    with _COUNTERS_LOCK:
        c = COUNTERS.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += seconds


class counted:
    """``span(name)`` whose events are counted (``count``)."""

    __slots__ = ("name", "inner", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.inner = span(self.name)
        self.inner.__enter__()
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        count(self.name, time.perf_counter() - self.t0)
        return self.inner.__exit__(*exc)


def counters() -> Dict[str, dict]:
    """A copy of ``COUNTERS``: name -> {count, seconds}."""
    with _COUNTERS_LOCK:
        return {k: {"count": int(n), "seconds": s}
                for k, (n, s) in COUNTERS.items()}


# -- the capture map --------------------------------------------------------

class CaptureMap:
    """The spans of one capture, by where the capture stood at their
    boundaries.

    ``mark()`` gives where the capture stands: the node or nodes that the
    next captured node will follow (``capture_mark`` on the card, the
    stream's capture dependencies; one call, no walk of the graph).
    ``finish(nodes, kinds, names)`` takes the graph's nodes in the order
    they were created, each node's CUgraphNodeType and each kernel node's
    name (or None), labels each node by the innermost span that holds it
    and keeps the kernel nodes: ``labels`` and ``names`` a kernel node,
    and ``driver_nodes``, the count of memcpy and of memset nodes (the
    driver may run such a node of a replayed graph as a kernel of its
    own, named ``memcpy...`` or ``memset...``, which a trace shows among
    the replay's kernels)."""

    def __init__(self, mark: Callable[[], tuple], k: int = 1):
        self.mark, self.k = mark, k
        self.thread = threading.get_ident()
        self.base = mark()
        self.stack: List[tuple] = []   # (name, mark at open)
        self.spans: List[tuple] = []   # (depth, mark at open, at close, name)
        self.result: Optional[dict] = None

    def here(self) -> bool:
        """Whether this thread takes part in the capture: the thread that
        captures, or the autograd engine's thread while it runs the
        captured backward (never a loader's thread, whose spans run at the
        same time)."""
        return (threading.get_ident() == self.thread
                or torch._C._current_graph_task_id() != -1)

    def open(self, name: str) -> None:
        self.stack.append((name, self.mark()))

    def close(self) -> None:
        name, first = self.stack.pop()
        end = self.mark()
        if end != first:
            self.spans.append((len(self.stack), first, end, name))

    def finish(self, nodes: list, kinds: List[int],
               names: Optional[List[Optional[str]]]) -> dict:
        if self.stack:
            raise RuntimeError(f"spans left open at the end of a capture: "
                               f"{[n for n, _ in self.stack]}")
        index = {node: i for i, node in enumerate(nodes)}

        def at(mark) -> int:  # nodes created before the mark
            return max((index[node] + 1 for node in mark), default=0)

        base = at(self.base)
        labels: List[Optional[str]] = [None] * (len(nodes) - base)
        for _, first, end, name in sorted(self.spans, key=lambda s: s[0]):
            a, b = at(first) - base, at(end) - base
            labels[a:b] = [name] * (b - a)
        kept, driver = [], dict.fromkeys(_DRIVER_KERNELS.values(), 0)
        for label, kind in zip(labels, kinds[base:]):
            if kind == KERNEL_NODE:
                kept.append(label)
            elif kind in _DRIVER_KERNELS:
                driver[_DRIVER_KERNELS[kind]] += 1
        if names is not None:  # those of the kernel nodes after the base
            names = names[len(names) - len(kept):]
        self.result = {"k": self.k, "nodes": len(labels),
                       "kernels": len(kept), "labels": kept,
                       "names": names, "driver_nodes": driver}
        return self.result


class capture_map:
    """``with capture_map(k):`` around the body of a CUDA graph capture,
    inside ``torch.cuda.graph``: spans record where the capture stood while
    it is open, and at its end the map (``CaptureMap.result``, also
    appended to ``CAPTURES``) holds the label of each kernel node. ``mark``
    and ``nodes`` default to the driver API's view of the current stream's
    capture (``capture_mark``, ``captured_nodes``)."""

    def __init__(self, k: int = 1, mark=None, nodes=None):
        self.k = k
        self.mark = mark or capture_mark
        self.nodes = nodes or captured_nodes
        self.map: Optional[CaptureMap] = None

    def __enter__(self) -> CaptureMap:
        global _capture
        if _capture is not None:
            raise RuntimeError("a capture map is open already")
        self.map = _capture = CaptureMap(self.mark, self.k)
        return self.map

    def __exit__(self, exc_type, *exc):
        global _capture
        _capture = None
        if exc_type is None:
            CAPTURES.append(self.map.finish(*self.nodes()))
        return False


class _Mark:
    """One call's span in its backward: opened when the gradient of its
    outputs arrives and closed when the gradient of its input leaves, in
    the capture map it was made under (while that capture is in progress)
    and, while a profiler runs, as a ``record_function`` range on the
    thread that runs the backward (the autograd engine's, for a card)."""

    __slots__ = ("name", "cap", "rf")

    def __init__(self, name: str, cap: Optional["CaptureMap"]):
        self.name, self.cap, self.rf = name, cap, None

    def open(self) -> None:
        if self.cap is not None and self.cap is _capture:
            self.cap.open(self.name)
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()

    def close(self) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        if self.cap is not None and self.cap is _capture:
            self.cap.close()


class _BwdOpen(torch.autograd.Function):
    """Identity on a module's outputs; its backward opens the span."""

    @staticmethod
    def forward(ctx, mark, *outs):
        ctx.mark = mark
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.mark.open()
        return (None,) + grads


class _BwdClose(torch.autograd.Function):
    """Identity on a module's input; its backward closes the span."""

    @staticmethod
    def forward(ctx, mark, x):
        ctx.mark = mark
        ctx.set_materialize_grads(False)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.mark.close()
        return None, grad


def _first_node(outs) -> Optional[torch.autograd.graph.Node]:
    """The node of the earliest op that made ``outs`` from inputs that take
    no gradient: the lowest sequence number among the nodes their
    gradients reach, the leaves' accumulators apart. The backward runs it
    last of them."""
    stack = [o.grad_fn for o in outs if o.grad_fn is not None]
    seen, first = set(), None
    while stack:
        node = stack.pop()
        if node is None or node in seen or not hasattr(node, "next_functions"):
            continue
        seen.add(node)
        if node.name().endswith("AccumulateGrad"):
            continue
        if first is None or node._sequence_nr() < first._sequence_nr():
            first = node
        stack.extend(n for n, _ in node.next_functions)
    return first


def spanned(name: str, fn: Callable, x: torch.Tensor, *args):
    """``fn(x, *args)`` in ``span(name)``; while a capture is in progress
    or a profiler runs, and a gradient flows back through the call, its
    backward too: ``_BwdOpen`` on the outputs (a tensor or a tuple of
    tensors), and ``_BwdClose`` on x, or where x takes no gradient (a
    network's stem) a hook after the call's first node. With neither, one
    flag check."""
    if _capture is None and not _autograd_profiler._is_profiler_enabled:
        return fn(x, *args)
    with span(name):
        cap = _capturing()
        if (cap is None and not _autograd_profiler._is_profiler_enabled) \
                or not torch.is_grad_enabled():
            return fn(x, *args)
        mark = _Mark(name, cap)
        out = fn(_BwdClose.apply(mark, x) if x.requires_grad else x, *args)
        many = isinstance(out, tuple)
        outs = out if many else (out,)
        if not any(o.requires_grad for o in outs):
            return out
        if not x.requires_grad:
            first = _first_node(outs)
            if first is None:
                return out
            first.register_hook(lambda grads_in, grads_out: mark.close())
        outs = _BwdOpen.apply(mark, *outs)
        return tuple(outs) if many else outs[0]


# -- the driver API's view of a capture --------------------------------------

KERNEL_NODE, MEMCPY_NODE, MEMSET_NODE = 0, 1, 2  # CU_GRAPH_NODE_TYPE_*
_DRIVER_KERNELS = {MEMCPY_NODE: "memcpy", MEMSET_NODE: "memset"}
_CAPTURE_ACTIVE = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2."""

    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


class _Driver:
    """The few driver functions the capture map needs, bound with ctypes
    on first use (never at import: the CPU has no libcuda)."""

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        self.capture_info = self._fn(
            lib, "cuStreamGetCaptureInfo_v2",
            [vp, ctypes.POINTER(ctypes.c_int),
             ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(vp),
             ctypes.POINTER(ctypes.POINTER(vp)), ctypes.POINTER(sz)])
        self.get_nodes = self._fn(lib, "cuGraphGetNodes",
                                  [vp, ctypes.POINTER(vp), ctypes.POINTER(sz)])
        self.node_type = self._fn(lib, "cuGraphNodeGetType",
                                  [vp, ctypes.POINTER(ctypes.c_int)])
        self.kernel_params = self._fn(
            lib, "cuGraphKernelNodeGetParams_v2",
            [vp, ctypes.POINTER(_KernelNodeParams)])
        # CUDA 12.3 and later; without them the map holds no names
        self.func_name = self._fn(lib, "cuFuncGetName",
                                  [ctypes.POINTER(ctypes.c_char_p), vp],
                                  optional=True)
        self.kernel_name = self._fn(lib, "cuKernelGetName",
                                    [ctypes.POINTER(ctypes.c_char_p), vp],
                                    optional=True)
        self.demangle = _Demangler()

    @staticmethod
    def _fn(lib, name, argtypes, optional=False):
        f = getattr(lib, name, None)
        if f is None:
            if optional:
                return None
            raise RuntimeError(f"libcuda has no {name}")
        f.argtypes, f.restype = argtypes, ctypes.c_int
        return f

    @staticmethod
    def check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    def capture(self):
        """(graph, the nodes the next captured node follows) of the current
        stream's capture, or None when it captures nothing."""
        status, graph = ctypes.c_int(0), ctypes.c_void_p()
        deps, n = ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t(0)
        stream = torch.cuda.current_stream().cuda_stream
        self.check(self.capture_info(stream, ctypes.byref(status), None,
                                     ctypes.byref(graph), ctypes.byref(deps),
                                     ctypes.byref(n)),
                   "cuStreamGetCaptureInfo")
        if status.value != _CAPTURE_ACTIVE:
            return None
        return graph.value, tuple(deps[i] for i in range(n.value))

    def nodes(self, graph: int) -> list:
        n = ctypes.c_size_t(0)
        self.check(self.get_nodes(graph, None, ctypes.byref(n)),
                   "cuGraphGetNodes")
        arr = (ctypes.c_void_p * n.value)()
        self.check(self.get_nodes(graph, arr, ctypes.byref(n)),
                   "cuGraphGetNodes")
        return list(arr)[:n.value]

    def name(self, node) -> Optional[str]:
        p = _KernelNodeParams()
        self.check(self.kernel_params(node, ctypes.byref(p)),
                   "cuGraphKernelNodeGetParams")
        out = ctypes.c_char_p()
        if p.func and self.func_name is not None:
            rc = self.func_name(ctypes.byref(out), p.func)
        elif p.kern and self.kernel_name is not None:
            rc = self.kernel_name(ctypes.byref(out), p.kern)
        else:
            return None
        return self.demangle(out.value) if rc == 0 and out.value else None


_driver: Optional[_Driver] = None


def _cuda() -> _Driver:
    global _driver
    if _driver is None:
        _driver = _Driver()
    return _driver


class _Demangler:
    """A kernel's name as the profiler writes it: libstdc++'s
    ``__cxa_demangle``, or the name as it is where that fails."""

    def __init__(self):
        self.cache: Dict[bytes, str] = {}
        self.fn = self.free = None
        try:
            cxx, libc = ctypes.CDLL("libstdc++.so.6"), ctypes.CDLL("libc.so.6")
        except OSError:
            return
        # getattr: a name with two leading underscores in a class body
        # is mangled by Python
        self.fn, self.free = getattr(cxx, "__cxa_demangle"), libc.free
        self.fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        self.fn.restype = ctypes.c_void_p
        self.free.argtypes = [ctypes.c_void_p]

    def __call__(self, raw: bytes) -> str:
        got = self.cache.get(raw)
        if got is None:
            got = raw.decode(errors="replace")
            if self.fn is not None:
                status = ctypes.c_int(-1)
                p = self.fn(raw, None, None, ctypes.byref(status))
                if p:
                    if status.value == 0:
                        got = ctypes.string_at(p).decode(errors="replace")
                    self.free(p)
            self.cache[raw] = got
        return got


def _stream_capture() -> tuple:
    got = _cuda().capture()
    if got is None:
        raise RuntimeError("the current stream is not capturing a graph")
    return got


def capture_mark() -> tuple:
    """The nodes the next node captured on the current CUDA stream will
    follow: the last node captured (empty at the start)."""
    return _stream_capture()[1]


def captured_nodes():
    """(nodes, kinds, names) of the current stream's capture, in the order
    they were created: the node handles, each node's CUgraphNodeType, and
    each kernel node's name where the driver gives it (None where not, or
    None for all)."""
    drv = _cuda()
    nodes = drv.nodes(_stream_capture()[0])
    kinds, names = [], []
    kind = ctypes.c_int(-1)
    for node in nodes:
        drv.check(drv.node_type(node, ctypes.byref(kind)),
                  "cuGraphNodeGetType")
        kinds.append(kind.value)
        if kind.value == KERNEL_NODE:
            names.append(drv.name(node))
    return nodes, kinds, (names if any(n is not None for n in names)
                          else None)


# -- StepProfiler ---------------------------------------------------------

class StepProfiler:
    """Traces loader indices [start, stop) of one epoch. With K steps a
    dispatch (K > 1), whole dispatches from the third on, the first that
    replays the graph the second captured: [2K, 2K + K * ceil(num_steps /
    K)); else [start_step, start_step + num_steps)."""

    def __init__(self, trace_dir: Optional[str], start_step: int = 2,
                 num_steps: int = 3, steps_per_dispatch: int = 1) -> None:
        k = max(1, steps_per_dispatch)
        if k > 1:
            start_step = 2 * k
            num_steps = k * math.ceil(num_steps / k)
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.path: Optional[str] = None  # the trace, once written
        self.spans_path: Optional[str] = None  # counters and capture maps
        self._prof = None
        self._done = False

    def step(self, global_step: int) -> None:
        """Call once per step with the running step index."""
        if not self.trace_dir or self._done:
            return
        if self._prof is None and global_step == self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # no earlier step in the trace
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and global_step >= self.stop_step:
            self._stop()

    def close(self) -> None:
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the traced steps' kernels finish
        self._prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        stem = os.path.join(self.trace_dir,
                            f"steps_{self.start_step}-{self.stop_step}_"
                            f"{time.time_ns()}")
        self.path = stem + ".pt.trace.json"
        self._prof.export_chrome_trace(self.path)
        self.spans_path = stem + ".spans.json"
        with open(self.spans_path, "w") as f:
            json.dump({"counters": counters(), "captures": list(CAPTURES)},
                      f)
        self._prof = None
        self._done = True
