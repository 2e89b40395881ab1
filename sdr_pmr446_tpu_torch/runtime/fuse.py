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
time group of several ranks) reads the host in its host-staged
collectives, which no CUDA graph can hold: its megastep is the loop of S
steps on the card too, equal bit for bit, and says so once in the log.

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
adds it at each replay: a count is launches that ran and delivered a
result, whether eagerly or in a replay.
"""

from __future__ import annotations

import gc
import logging
import sys
import time
from typing import Callable, Dict, Tuple

import torch

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


class CudaGraphRecorder:
    """Captures into and replays one ``torch.cuda.CUDAGraph``; the capture
    runs on ``stream`` (the warm-up's side stream), a replay on the
    current stream."""

    def __init__(self, stream: torch.cuda.Stream):
        self.stream = stream
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable):
        # a chain is a reference cycle (its megastep holds its step), so
        # a dead chain's graphs die when the cycle collector runs; one
        # that ran inside a capture would reset a graph there and void
        # the capture: collect first, and not during the capture
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=self.stream):
                return fn()
        finally:
            if enabled:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


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
    """One megastep's graph: its static inputs, and the new state and the
    S steps' outputs it writes."""

    def __init__(self, step: Callable, dim: int, state, xs, args):
        dev = xs.device
        self.dim = dim
        self.state = [t.clone() for t in _leaves(state)]
        self.xs = xs.clone()
        self.args = [[t.clone() for t in _leaves(a)] for a in args]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self.graph = CountedGraph(CudaGraphRecorder(side))

        def body():
            st = _rebuild(state, self.state)
            params = [_rebuild(a, v) for a, v in zip(args, self.args)]
            outs = []
            for x in self.xs:
                st, out = step(st, x, *params)
                outs.append(out)
            return st, outs

        t0 = time.perf_counter()

        def warmup():
            with torch.cuda.stream(side):
                body()
            side.synchronize()
            self.warmup_ms = (time.perf_counter() - t0) * 1e3

        self.new_state, self.outs = self.graph.capture(body, warmup)
        torch.cuda.current_stream(dev).wait_stream(side)
        #: host ms of the capture with the graph's instantiation (and of
        #: the warm-up, ``warmup_ms``)
        self.capture_ms = (time.perf_counter() - t0) * 1e3 - self.warmup_ms

    def __call__(self, state, xs, args):
        for dst, src in zip(self.state, _leaves(state)):
            dst.copy_(src)
        self.xs.copy_(xs)
        for dsts, a in zip(self.args, args):
            for dst, src in zip(dsts, _leaves(a)):
                dst.copy_(src)
        self.graph.replay()
        # fresh tensors: the next replay rewrites the graph's own
        new_state = [t.clone() for t in _leaves(self.new_state)]
        return (_rebuild(self.new_state, new_state),
                _concat(self.outs, self.dim))


class Megastep:
    """``fused(state, xs[S, ...], *args) -> (state', outs)``: S calls of
    ``step(state, xs[i], *args)``, each output leaf concatenated along
    ``dim`` (0: [S*K, ...], 1: [n_streams, S*K, ...]).  On a CUDA device a
    captured graph a set of shapes (``graphs``), on the CPU the loop; the
    loop on the card too where ``collective`` (the step runs host-staged
    collectives)."""

    def __init__(self, step: Callable, dim: int = 0,
                 collective: bool = False):
        self.step = step
        self.dim = dim
        self.collective = collective
        self.said_loop = False
        self.graphs: Dict[tuple, _Captured] = {}

    def loop(self, state, xs, *args):
        """The S steps one after the other (the CPU's megastep)."""
        outs = []
        for x in xs:
            state, out = self.step(state, x, *args)
            outs.append(out)
        return state, _concat(outs, self.dim)

    def __call__(self, state, xs: torch.Tensor, *args):
        if xs.dim() < 1 or xs.shape[0] < 1:
            raise ValueError(f"xs must stack at least one block, got shape "
                             f"{tuple(xs.shape)}")
        if xs.device.type == "cpu":
            return self.loop(state, xs, *args)
        if xs.device.type != "cuda":
            raise ValueError(f"no megastep for device {xs.device}")
        if self.collective:
            if not self.said_loop:
                log.info("the step's halos cross processes (host-staged "
                         "collectives): multi_step runs its %d steps as a "
                         "loop, not a CUDA graph", xs.shape[0])
                self.said_loop = True
            return self.loop(state, xs, *args)
        key = _signature(state, xs, *args)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = _Captured(self.step, self.dim,
                                                 state, xs, args)
        return graph(state, xs, args)


def fused_steps(step: Callable) -> Megastep:
    """The megastep of a block step: outputs [S*K, ...] (JAX
    ``fused_steps``)."""
    return Megastep(step, dim=0)


def fused_sharded_steps(step: Callable, time_ranks: int = 1) -> Megastep:
    """The megastep of a sharded block step over [n_streams, ...] inputs:
    xs [S, n_streams, ...], outputs stream-major [n_streams, S*K, ...]
    (JAX ``fused_sharded_steps``); ``time_ranks`` > 1 (a time group over
    several processes) makes it the loop."""
    return Megastep(step, dim=1, collective=time_ranks > 1)
