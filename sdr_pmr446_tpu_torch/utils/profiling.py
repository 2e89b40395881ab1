"""The port's span recorder and counters, JSONL metrics records and a
profiler trace.

Counterpart of sdr_pmr446_tpu/utils/profiling.py, rewritten on PyTorch:

  - the span recorder: ``span(name, block)`` around a piece of host work
    at a layer boundary (runtime/driver.py, runtime/batch.py,
    runtime/fuse.py, parallel/distributed.py), ``record``
    for a span stamped by its caller; off by default, switched by
    ``enable()`` / ``disable()`` (or ``recording()``), read by
    ``snapshot()``;
  - counters (``count``): plain integers, always on, bumped at most once a
    block or a dispatch;
  - ``log_jsonl``: append one structured record a line (the driver's
    per-sub-chunk metrics, runtime/driver.py);
  - ``trace``: ``torch.profiler`` around a code region, its Chrome trace
    written to ``<log_dir>/trace.json`` (CUDA activity too when a card is
    present), in place of ``jax.profiler``'s XProf trace; with the
    recorder on, the program's spans on the same timeline and the
    counters in ``<log_dir>/counters.json``.

Off, ``span`` is one check of a module global that returns a shared no-op
context: it allocates nothing and calls nothing of the profiler (a
``torch.profiler.record_function`` costs microseconds a span even with no
profiler running).  On, a span is a list of five items appended to the
recorder's list, stamped with ``time.perf_counter_ns``; ``snapshot``
converts the stamps to the Unix-epoch nanoseconds that torch.profiler's
events carry, by an anchor pair taken at ``enable``, so an idle gap in the
device trace can be put down to the innermost span over it.  The recorder
keeps the first ``cap`` spans and counts the rest as dropped.  Spans are
taken on one thread, the one that runs the scan: a span's parent is the
span open when it began.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import torch

#: spans one ``enable()`` keeps; the rest are counted as dropped (a span
#: takes ~0.2 KB; the driver takes ~5 a block at 8 blocks a dispatch)
SPAN_CAP = 1 << 18

#: the program's counters, always on: name -> count.  runtime/driver.py:
#: ``driver.blocks`` / ``driver.dispatches`` / ``driver.eager_steps``
#: (blocks stepped; chain calls; of them single steps outside a graph),
#: ``prefetch.bytes`` (wire bytes staged), ``prefetch.slot_waits_blocked``
#: (ring slots whose last copy had not finished), ``drain.subchunks`` /
#: ``drain.audio_subchunks`` / ``drain.events`` (sub-chunks drained; of
#: them with audio; log lines), ``drain.waits_blocked`` (drains whose
#: dispatch's read-back had not finished); runtime/fuse.py
#: ``megastep.captures`` (graphs captured); kernels/build.py
#: ``kernels.library_loads``; runtime/batch.py ``batch.groups`` /
#: ``batch.blocks`` (dispatches; blocks dispatched)
COUNTS: Dict[str, int] = dict.fromkeys((
    "driver.blocks", "driver.dispatches", "driver.eager_steps",
    "prefetch.bytes", "prefetch.slot_waits_blocked", "megastep.captures",
    "kernels.library_loads", "drain.subchunks", "drain.audio_subchunks",
    "drain.events", "drain.waits_blocked", "batch.groups", "batch.blocks"),
    0)

#: the Chrome trace's thread id of the program's spans
PROGRAM_TID = 1 << 30


class Span(NamedTuple):
    """One span of a snapshot: times in Unix-epoch ns (torch.profiler's
    clock), ``parent`` the index of the span open when it began (-1: none
    or dropped), ``block`` the first stream-block it concerns (inherited
    from its parent when not given; None: none), ``self_ns`` its duration
    less the time its children cover."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    block: Optional[int]
    self_ns: int


@dataclasses.dataclass
class Snapshot:
    spans: List[Span]
    dropped: int                 # spans past the cap, not kept
    counters: Dict[str, int]     # COUNTS
    launches: Dict[str, int]     # fuse.launch_counts(), "module.ATTR"
    distributed: Optional[dict]  # parallel/distributed.py STATS, if loaded

    def counts(self) -> dict:
        """The counters as ``counters.json`` holds them."""
        return {"counters": self.counters, "launches": self.launches,
                "distributed": self.distributed, "spans": len(self.spans),
                "spans_dropped": self.dropped}


class _Recorder:
    """One ``enable()``'s spans: rows [name, start, end, parent, block]
    on the perf_counter clock, the stack of open spans (row index, block)
    and the perf_counter -> epoch offset."""

    def __init__(self, cap: int):
        self.cap = cap
        self.rows: list = []
        self.stack: list = []
        self.dropped = 0
        p0 = time.perf_counter_ns()
        epoch = time.time_ns()
        p1 = time.perf_counter_ns()
        self.offset = epoch - (p0 + p1) // 2

    def open(self, name: str, block: Optional[int], start: int) -> tuple:
        parent, inherited = self.stack[-1] if self.stack else (-1, None)
        if block is None:
            block = inherited
        if len(self.rows) < self.cap:
            index = len(self.rows)
            self.rows.append([name, start, start, parent, block])
        else:
            index = -1
            self.dropped += 1
        return index, block


#: the recorder while on, else None (the one check ``span`` makes)
_REC: Optional[_Recorder] = None
#: the recording that ``disable()`` ended, for ``snapshot()``
_LAST: Optional[_Recorder] = None


class _Span:
    __slots__ = ("name", "block", "rec", "index")

    def __init__(self, name: str, block: Optional[int], rec: _Recorder):
        self.name, self.block, self.rec = name, block, rec

    def __enter__(self):
        rec = self.rec
        entry = rec.open(self.name, self.block, 0)
        rec.stack.append(entry)
        self.index = entry[0]
        if self.index >= 0:
            rec.rows[self.index][1] = time.perf_counter_ns()

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        rec = self.rec
        rec.stack.pop()
        if self.index >= 0:
            rec.rows[self.index][2] = t
        return False


_NULL = contextlib.nullcontext()


def span(name: str, block: Optional[int] = None):
    """A context manager that records ``name`` over its body while the
    recorder is on, ``block`` the first stream-block the work concerns
    (None: its parent's); off, a shared no-op."""
    if _REC is None:
        return _NULL
    return _Span(name, block, _REC)


def record(name: str, start_ns: int, end_ns: int,
           block: Optional[int] = None) -> None:
    """A finished span stamped by the caller (``time.perf_counter_ns``),
    as a child of the span open now; nothing while the recorder is off."""
    rec = _REC
    if rec is not None:
        index, _ = rec.open(name, block, start_ns)
        if index >= 0:
            rec.rows[index][2] = end_ns


def enabled() -> bool:
    return _REC is not None


def enable(cap: int = SPAN_CAP) -> None:
    """Start a new recording (the spans of an earlier one are dropped)."""
    global _REC
    _REC = _Recorder(cap)


def disable() -> None:
    """Stop recording; ``snapshot()`` still reads the spans taken."""
    global _REC, _LAST
    _LAST, _REC = _REC, None


@contextlib.contextmanager
def recording(cap: int = SPAN_CAP):
    """The recorder on over the body."""
    enable(cap)
    try:
        yield
    finally:
        disable()


class Summed:
    """``fn`` whose calls' time is summed in ``ns``: one span
    (``record``) for many short calls, taken only while recording."""

    def __init__(self, fn):
        self.fn, self.ns = fn, 0

    def __call__(self, *args):
        t = time.perf_counter_ns()
        self.fn(*args)
        self.ns += time.perf_counter_ns() - t


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (one of ``COUNTS``)."""
    COUNTS[name] += n


def snapshot() -> Snapshot:
    """The current (or last) recording's spans on the epoch clock, with
    their self times, and every counter read where it lives."""
    from sdr_pmr446_tpu_torch.runtime import fuse
    rec = _REC if _REC is not None else _LAST
    spans: List[Span] = []
    dropped = 0
    if rec is not None:
        rows = rec.rows
        self_ns = [r[2] - r[1] for r in rows]
        for r in rows:
            if r[3] >= 0:
                self_ns[r[3]] -= r[2] - r[1]
        off = rec.offset
        spans = [Span(r[0], r[1] + off, r[2] + off, r[3], r[4], s)
                 for r, s in zip(rows, self_ns)]
        dropped = rec.dropped
    dist = sys.modules.get("sdr_pmr446_tpu_torch.parallel.distributed")
    return Snapshot(
        spans=spans, dropped=dropped, counters=dict(COUNTS),
        launches={f"{mod.rsplit('.', 1)[-1]}.{attr}": n
                  for (mod, attr), n in fuse.launch_counts().items()},
        distributed=dict(dist.STATS) if dist is not None else None)


def _chrome_events(spans: List[Span], first: int, base_ns: int,
                  pid: int) -> list:
    """Spans ``first`` on as Chrome trace events (complete events on one
    thread of their own, µs from ``base_ns``, the trace's
    ``baseTimeNanoseconds``; ``index`` and ``parent`` count in ``spans``)."""
    events = [{"ph": "M", "name": "thread_name", "pid": pid,
               "tid": PROGRAM_TID, "args": {"name": "program spans"}}]
    for i, s in enumerate(spans[first:], first):
        events.append({
            "ph": "X", "cat": "program", "name": s.name, "pid": pid,
            "tid": PROGRAM_TID, "ts": (s.start_ns - base_ns) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"index": i, "parent": s.parent, "block": s.block,
                     "self_us": s.self_ns / 1e3}})
    return events


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with torch.profiler; the Chrome trace (chrome://
    tracing, Perfetto) goes to ``<log_dir>/trace.json``.  While the
    recorder is on, the spans taken in the body join the trace on their
    own thread and the counters go to ``<log_dir>/counters.json``.  Yields
    the profiler, whose ``key_averages()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = len(_REC.rows) if _REC is not None else None
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if first is None:
        return
    snap = snapshot()
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(_chrome_events(
        snap.spans, first, int(doc.get("baseTimeNanoseconds", 0)),
        os.getpid()))
    with open(path, "w") as f:
        json.dump(doc, f)
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(snap.counts(), f, indent=1)


def log_jsonl(path: str, record: dict) -> None:
    """Append one structured metrics record (per-sub-chunk event stream)."""
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
