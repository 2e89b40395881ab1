"""The program's own spans in a run, beside the device trace.

The port records spans at its layer boundaries when its recorder is on
(``sdr_pmr446_tpu_torch/utils/profiling.py``: ``enable()``,
``snapshot()``), on the clock of torch.profiler's events (Unix-epoch ns).
An entry that turns the recorder on for a traced run hands the spans over
as ``program_spans(snapshot)`` gives them: (name, start ns, end ns, self
ns, block).  This module reads them:

  - ``CorrelatedTracer``: ``trace.Tracer`` that also keeps each event's
    kineto correlation id (``correlation``, in the order of ``events``),
    which ties a device event to the runtime call that launched it;
  - ``reduce``: ``trace.reduce``, with ``spans`` the idle gaps named by
    the innermost span over each gap's middle, harness (``bench:``) or
    program; every other number as ``trace.reduce`` computes it;
  - the per-block readings of the host's spans (``self_ms``) over the
    untraced part of a window, and of the device time launched from
    inside given spans (``launched_ms``);
  - ``first_dispatch_s``: the first megastep's warm-up and capture.

A tree whose program records no span hands over none, and every reader
here then finds nothing (None).
"""

from __future__ import annotations

import bisect

from benchlib import trace
from benchlib.trace import SPAN_PREFIX, Tracer

#: the spans outside the chain's step call, and the megastep's own
OUTSIDE_STEP = ("prefetch.source", "prefetch.slot_wait", "prefetch.pin",
                "prefetch.host_copy", "prefetch.upload", "dispatch.stack",
                "drain.wait", "drain.fetch", "drain.subchunks",
                "drain.on_subchunk")
MEGASTEP = ("megastep.call", "megastep.stage", "megastep.replay",
            "megastep.collect")
#: the copies around a graph replay: stacking the blocks, staging the
#: static inputs, cloning the state and concatenating the outputs
COPIES = ("dispatch.stack", "megastep.stage", "megastep.collect")


def program_spans(snapshot) -> list:
    """A recorder snapshot's spans as (name, start, end, self, block)."""
    return [(s.name, s.start_ns, s.end_ns, s.self_ns, s.block)
            for s in snapshot.spans]


class CorrelatedTracer(Tracer):
    """``Tracer`` that keeps, beside ``events``, each event's kineto
    correlation id (``correlation[i]`` is ``events[i]``'s)."""

    def __init__(self, device):
        super().__init__(device)
        self.correlation: list = []

    def end(self) -> None:
        prof = self.prof
        super().end()
        self.correlation = [e.correlation_id()
                            for e in prof.profiler.kineto_results.events()]


def idle_gaps(events: list) -> list:
    """The gaps (start ns, end ns) between the union of the device
    events' intervals, as ``trace.reduce`` finds them."""
    gaps, end = [], None
    for _, kind, a, b in sorted((e for e in events if e[1] == "device"),
                                key=lambda e: e[2]):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


class Innermost:
    """The innermost (shortest) of a set of (start, end, name) intervals
    over a time; None where none is."""

    def __init__(self, intervals: list):
        self.spans = sorted(s for s in intervals if s[1] > s[0])
        self.starts = [s[0] for s in self.spans]
        self.longest = max((s[1] - s[0] for s in self.spans), default=0)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t)
        j = bisect.bisect_left(self.starts, t - self.longest)
        inner = [s for s in self.spans[j:i] if t <= s[1]]
        return min(inner, key=lambda s: s[1] - s[0])[2] if inner else None


def reduce(events: list, outside: str = "host outside the harness's spans",
           spans: list | None = None) -> dict:
    """``trace.reduce(events, outside)``; with ``spans`` (program spans,
    ``program_spans``) the idle gaps are named by the innermost span over
    each gap's middle among the harness's and the program's, ``outside``
    where none is."""
    out = trace.reduce(events, outside)
    if spans is None:
        return out
    over = Innermost(
        [(a, b, name) for name, kind, a, b in events
         if kind == "host" and name.startswith(SPAN_PREFIX)]
        + [(a, b, name) for name, a, b, _, _ in spans])
    by_span: dict = {}
    for a, b in idle_gaps(events):
        label = over.at((a + b) / 2) or outside
        by_span[label] = by_span.get(label, 0.0) + (b - a) / 1e9
    out["idle_by_span_s"] = by_span
    return out


def self_ms(spans: list, names: tuple, lo_ns: int, hi_ns: int) -> float:
    """The self time (ms) of the spans named ``names`` that lie inside
    [lo_ns, hi_ns]."""
    return sum(s for name, a, b, s, _ in spans
               if name in names and a >= lo_ns and b <= hi_ns) / 1e6


def runtime_call(name: str) -> bool:
    """A CUDA runtime (``cuda*``) or driver (``cu[A-Z]*``) API call: the
    host events that launch device work."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def launched_ms(events: list, correlation: list, spans: list,
                names: tuple) -> tuple:
    """(device ms of the events whose launching runtime call lies in a
    program span named ``names`` (the innermost over the call's start),
    the share of all device time whose launching call was found).  A
    device event and the runtime call that launched it (a kernel of a
    replayed graph: the graph's launch) share a kineto correlation id."""
    calls = {}
    for (name, kind, a, b), cid in zip(events, correlation):
        if kind == "host" and runtime_call(name):
            calls.setdefault(cid, a)
    over = Innermost([(a, b, name) for name, a, b, _, _ in spans])
    total = found = inside = 0
    for (name, kind, a, b), cid in zip(events, correlation):
        if kind != "device":
            continue
        total += b - a
        start = calls.get(cid)
        if start is None:
            continue
        found += b - a
        if over.at(start) in names:
            inside += b - a
    return inside / 1e6, (found / total if total else 0.0)


def first_dispatch_s(spans: list) -> float | None:
    """The first megastep's warm-up and capture (s): the first
    ``megastep.warmup`` and the first ``megastep.capture``."""
    firsts = {}
    for name, a, b, _, _ in spans:
        if name in ("megastep.warmup", "megastep.capture"):
            firsts.setdefault(name, (b - a) / 1e9)
    if len(firsts) < 2:
        return None
    return sum(firsts.values())

