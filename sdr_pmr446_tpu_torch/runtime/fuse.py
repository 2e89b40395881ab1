"""Multi-block dispatch: S block steps as one CUDA graph (PyTorch).

Counterpart of sdr_pmr446_tpu/runtime/fuse.py (``fused_steps``,
``fused_sharded_steps``).  Every chain is a block step ``(state, x, *args)
-> (state', out)``; a streaming caller fuses S consecutive blocks into one
dispatch, ``fused(state, xs[S, ...], *args) -> (state', outs)``, with every
output leaf the in-order concatenation of the S steps' outputs: [S*K, ...]
(JAX ``_flatten_leading``), or [n_streams, S*K, ...] for the sharded
chains (JAX ``_flatten_stream_major``).  ``args`` (runtime params) go to
every step.

JAX runs the S steps under ``lax.scan`` in one jitted call.  Here, on a
CUDA device, the S steps are captured once into a CUDA graph
(``torch.cuda.CUDAGraph``) at the first call for each S and each set of
shapes, and every call replays it: the host pays one graph launch instead
of the kernels' and ops' launches and the wrappers' Python.  The graph
holds exactly the kernels and ops that S calls of the step launch, in the
same order on the same stream, so a megastep's outputs and state are bit
for bit those of S steps (JAX's scan body recompiles and agrees to f32
rounding only).  On the CPU, which a caller asks for with ``device="cpu"``,
the megastep is the plain loop of S steps.  There is no fallback: on a
CUDA device a capture or replay error raises.

A sharded step whose halos cross processes (parallel/distributed.py: a
time group of several ranks) runs host-staged gloo collectives, which no
CUDA graph can hold.  Its S steps are captured as an ordered list of
graphs, segment 0 .. n, cut at each collective (``SegmentedGraphRecorder``):
segment k ends with a captured copy of the collective's send bytes into a
static pinned host buffer, segment k + 1 begins with a captured copy of
the static pinned receive buffer to the device, and a replay runs segment
k, waits for it, runs the gloo collective on the pinned buffers, then runs
segment k + 1.  The warm-up runs the real collectives and plans the
buffers; the capture exchanges nothing (no kernel runs), so every rank of
the group captures in the same megastep call, and then the ranks agree on
the schedule (the number of collectives and their sizes) with one
collective.  The outputs are bit for bit the loop of the S steps.

A graph reads and writes fixed buffers, so a call copies the caller's
state, inputs and params into the graph's static inputs on the device,
replays, and returns copies of the graph's outputs and new state: a state
or an output that a call returned never changes because of a later call,
as JAX arrays never do (the driver drains megastep i after it dispatches
i + 1).  Before the capture the S steps run once, on a side stream, on
those static copies, whose values the steps only read: that first use
builds the kernel library and fills the per-device tables the kernels and
the FSM cache (an upload from the host during a capture is an error).

Launch counts.  The kernel wrappers count a launch when they are called
(``LAUNCHES`` in kernels/*.py), so the warm-up and the capture would count
launches that a replay makes.  ``CountedGraph`` takes back what the
warm-up and the capture counted, records what the capture counted, and
adds it at each replay (of every segment): a count is launches that ran
and delivered a result, whether eagerly or in a replay.

Spans (utils/profiling.py, while the recorder is on): ``megastep.call``
over a megastep call, whose self time is the megastep's own host work
outside the spans below (the shapes' signature and the graph's lookup on
the card, the loop on the CPU); a graph's first call records
``megastep.warmup`` and ``megastep.capture`` (the stamps its ``warmup_ms``
/ ``capture_ms`` read) and counts ``megastep.captures``; every call on the
card ``megastep.stage`` (the copies into the static inputs),
``megastep.replay`` and ``megastep.collect`` (the new state's clones and
the outputs' concatenation).
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import logging
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from sdr_pmr446_tpu_torch.utils.profiling import count, record, span

#: the package whose modules hold the kernels' launch counters
KERNELS = "sdr_pmr446_tpu_torch.kernels"

log = logging.getLogger("fuse")


# ------------------------------------------------------------ launch counts
def launch_counts() -> Dict[Tuple[str, str], int]:
    """Every integer ``*LAUNCHES`` counter of the loaded kernel modules,
    keyed by (module name, attribute)."""
    counts = {}
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith(KERNELS + "."):
            continue
        for attr, value in vars(mod).items():
            if attr.endswith("LAUNCHES") and type(value) is int:
                counts[(name, attr)] = value
    return counts


def set_launch_counts(counts: Dict[Tuple[str, str], int]) -> None:
    for (name, attr), value in counts.items():
        setattr(sys.modules[name], attr, value)


def add_launch_counts(delta: Dict[Tuple[str, str], int]) -> None:
    for (name, attr), n in delta.items():
        mod = sys.modules[name]
        setattr(mod, attr, getattr(mod, attr) + n)


@contextlib.contextmanager
def _collected_first():
    """The cycle collector run now and off until the context ends.  A
    chain is a reference cycle (its megastep holds its step), so a dead
    chain's graphs die when the collector runs; a run inside a capture
    would reset a graph there and void the capture."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class CudaGraphRecorder:
    """Captures into and replays one ``torch.cuda.CUDAGraph``; the capture
    runs on ``stream`` (the warm-up's side stream), a replay on the
    current stream."""

    def __init__(self, stream: torch.cuda.Stream):
        self.stream = stream
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable):
        with _collected_first(), torch.cuda.graph(self.graph,
                                                  stream=self.stream):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


class SegmentedGraphRecorder:
    """Captures a body that runs host exchanges (a time split's host-staged
    collectives) as an ordered list of CUDA graphs, and replays them with
    each exchange between its two graphs.  The interface of
    ``CudaGraphRecorder`` (``capture(fn)``, ``replay()``), plus:

      - ``active(False)``: the context of the eager warm-up, during which
        each exchange runs for real and adds its ``Exchange`` (static
        pinned buffers, parallel/distributed.py) to ``planned``, in order;
      - ``cut()``: called by the k-th exchange inside the capture, returns
        its planned ``Exchange`` after ending the current graph and
        beginning the next (the caller captured its send copy before and
        captures its receive copy after).

    After the capture the exchanges' group agrees on the schedule
    (``Exchange.agree``); a mismatch raises.

    Every graph draws from one memory pool: tensors made in segment k and
    read in segment k + 1 stay valid, as the segments always replay in the
    order they were captured."""

    def __init__(self, stream: torch.cuda.Stream):
        self.stream = stream
        self.graphs: list = []
        self.planned: list = []
        self.cuts: list = []
        self.capturing = False
        self._pool = None

    @contextlib.contextmanager
    def active(self, capturing: bool):
        """This recorder as ``segmenting()``'s answer, planning (the
        warm-up) or capturing."""
        global _ACTIVE
        _ACTIVE, self.capturing = self, capturing
        try:
            yield
        finally:
            _ACTIVE, self.capturing = None, False

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool)
        self.graphs.append(graph)

    def cut(self):
        if len(self.cuts) >= len(self.planned):
            raise RuntimeError(
                f"the capture made a collective the warm-up did not (number "
                f"{len(self.cuts) + 1}, the warm-up made {len(self.planned)})")
        self.graphs[-1].capture_end()
        self.cuts.append(self.planned[len(self.cuts)])
        self._begin()
        return self.cuts[-1]

    def capture(self, fn: Callable):
        torch.cuda.synchronize(self.stream.device)
        self._pool = torch.cuda.graph_pool_handle()
        self.graphs, self.cuts = [], []
        with _collected_first(), torch.cuda.stream(self.stream):
            self._begin()
            try:
                with self.active(True):
                    result = fn()
            finally:
                self.graphs[-1].capture_end()
        if len(self.cuts) != len(self.planned):
            raise RuntimeError(
                f"the capture made {len(self.cuts)} collectives, the warm-up "
                f"{len(self.planned)}")
        if self.cuts:
            self.cuts[0].agree(self.cuts)
        return result

    def replay(self) -> None:
        for graph, exchange in itertools.zip_longest(self.graphs, self.cuts):
            graph.replay()
            if exchange is not None:
                exchange()


#: the segmented recorder whose warm-up or capture is running, if any: a
#: CUDA capture holds the whole thread, so one at a time per process, set
#: only inside ``SegmentedGraphRecorder.active``
_ACTIVE: Optional[SegmentedGraphRecorder] = None


def segmenting() -> Optional[SegmentedGraphRecorder]:
    """The ``SegmentedGraphRecorder`` planning (``.capturing`` False) or
    capturing (True) right now, or None: parallel/distributed.py's
    ``all_gather`` asks, to plan its buffers or to cut the capture."""
    return _ACTIVE


class CountedGraph:
    """A recorder (``capture(fn)``, ``replay()``) whose captures count no
    launch and whose replays count the launches the capture recorded."""

    def __init__(self, recorder):
        self.recorder = recorder
        self.delta: Dict[Tuple[str, str], int] = {}

    def capture(self, fn: Callable, warmup: Callable | None = None):
        """``warmup()`` (launches that run but deliver nothing), then
        ``fn()`` under capture; returns what ``fn`` returned."""
        before = launch_counts()
        try:
            if warmup is not None:
                warmup()
            start = launch_counts()
            result = self.recorder.capture(fn)
            end = launch_counts()
        finally:
            # a kernel module first imported by the warm-up or the capture
            # counted from 0 before it existed
            set_launch_counts({**{key: 0 for key in launch_counts()},
                               **before})
        self.delta = {key: n - start.get(key, 0) for key, n in end.items()
                      if n != start.get(key, 0)}
        return result

    def replay(self) -> None:
        self.recorder.replay()
        add_launch_counts(self.delta)


# -------------------------------------------------------------- megasteps
def _leaves(tree) -> list:
    """The tensors of a state, output or params: a (named) tuple of tensors
    or one tensor."""
    return list(tree) if isinstance(tree, tuple) else [tree]


def _rebuild(like, leaves: list):
    if not isinstance(like, tuple):
        return leaves[0]
    return type(like)(*leaves) if hasattr(like, "_fields") else tuple(leaves)


def _signature(*trees) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for tree in trees
                 for t in _leaves(tree))


def _concat(outs: list, dim: int):
    """The S steps' outputs, each leaf concatenated along ``dim``."""
    cat = [torch.cat(vs, dim=dim) for vs in zip(*map(_leaves, outs))]
    return _rebuild(outs[0], cat)


class _Captured:
    """One megastep's graph (with ``segmented``, its segments around the
    step's host-staged collectives): its static inputs, and the new state
    and the S steps' outputs it writes."""

    def __init__(self, step: Callable, dim: int, state, xs, args,
                 segmented: bool = False):
        dev = xs.device
        self.dim = dim
        self.state = [t.clone() for t in _leaves(state)]
        self.xs = xs.clone()
        self.args = [[t.clone() for t in _leaves(a)] for a in args]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        recorder = (SegmentedGraphRecorder if segmented
                    else CudaGraphRecorder)(side)
        self.graph = CountedGraph(recorder)

        def body():
            st = _rebuild(state, self.state)
            params = [_rebuild(a, v) for a, v in zip(args, self.args)]
            outs = []
            for x in self.xs:
                st, out = step(st, x, *params)
                outs.append(out)
            return st, outs

        stamps = [time.perf_counter_ns()]

        def warmup():
            with torch.cuda.stream(side), (recorder.active(False)
                                           if segmented
                                           else contextlib.nullcontext()):
                body()
            side.synchronize()
            stamps.append(time.perf_counter_ns())

        self.new_state, self.outs = self.graph.capture(body, warmup)
        torch.cuda.current_stream(dev).wait_stream(side)
        stamps.append(time.perf_counter_ns())
        record("megastep.warmup", stamps[0], stamps[1])
        record("megastep.capture", stamps[1], stamps[2])
        count("megastep.captures")
        #: host ms of the warm-up, and of the capture with the graph's
        #: instantiation
        self.warmup_ms = (stamps[1] - stamps[0]) / 1e6
        self.capture_ms = (stamps[2] - stamps[1]) / 1e6

    def __call__(self, state, xs, args):
        with span("megastep.stage"):
            for dst, src in zip(self.state, _leaves(state)):
                dst.copy_(src)
            self.xs.copy_(xs)
            for dsts, a in zip(self.args, args):
                for dst, src in zip(dsts, _leaves(a)):
                    dst.copy_(src)
        with span("megastep.replay"):
            self.graph.replay()
        with span("megastep.collect"):
            # fresh tensors: the next replay rewrites the graph's own
            new_state = [t.clone() for t in _leaves(self.new_state)]
            outs = _concat(self.outs, self.dim)
        return _rebuild(self.new_state, new_state), outs


class Megastep:
    """``fused(state, xs[S, ...], *args) -> (state', outs)``: S calls of
    ``step(state, xs[i], *args)``, each output leaf concatenated along
    ``dim`` (0: [S*K, ...], 1: [n_streams, S*K, ...]).  On a CUDA device a
    captured graph a set of shapes (``graphs``), with ``segmented`` (the
    step runs host-staged collectives) graph segments around them; on the
    CPU the loop."""

    def __init__(self, step: Callable, dim: int = 0,
                 segmented: bool = False):
        self.step = step
        self.dim = dim
        self.segmented = segmented
        self.graphs: Dict[tuple, _Captured] = {}

    def loop(self, state, xs, *args):
        """The S steps one after the other (the CPU's megastep)."""
        outs = []
        for x in xs:
            state, out = self.step(state, x, *args)
            outs.append(out)
        return state, _concat(outs, self.dim)

    def __call__(self, state, xs: torch.Tensor, *args):
        with span("megastep.call"):
            return self._call(state, xs, *args)

    def _call(self, state, xs: torch.Tensor, *args):
        if xs.dim() < 1 or xs.shape[0] < 1:
            raise ValueError(f"xs must stack at least one block, got shape "
                             f"{tuple(xs.shape)}")
        if xs.device.type == "cpu":
            return self.loop(state, xs, *args)
        if xs.device.type != "cuda":
            raise ValueError(f"no megastep for device {xs.device}")
        key = _signature(state, xs, *args)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = _Captured(self.step, self.dim,
                                                 state, xs, args,
                                                 self.segmented)
            if self.segmented:
                log.info("the step's halos cross processes: multi_step "
                         "captured its %d steps as %d CUDA graphs around %d "
                         "host-staged collectives", xs.shape[0],
                         len(graph.graph.recorder.graphs),
                         len(graph.graph.recorder.cuts))
        return graph(state, xs, args)


def fused_steps(step: Callable) -> Megastep:
    """The megastep of a block step: outputs [S*K, ...] (JAX
    ``fused_steps``)."""
    return Megastep(step, dim=0)


def fused_sharded_steps(step: Callable, time_ranks: int = 1) -> Megastep:
    """The megastep of a sharded block step over [n_streams, ...] inputs:
    xs [S, n_streams, ...], outputs stream-major [n_streams, S*K, ...]
    (JAX ``fused_sharded_steps``); ``time_ranks`` > 1 (a time group over
    several processes) captures it in segments around the collectives."""
    return Megastep(step, dim=1, segmented=time_ranks > 1)
