"""What an entry hands back from its window, and the pieces entries share.

An entry (entries/*.py) builds the program's object for its configuration,
warms it on the cell's traffic, runs the measured window, and returns a
``Window``: the host clock's stamps, the harness's spans, the trace of a
sub-window when asked for, and the outputs of a sample of stream-blocks
drawn from the seed, each with the bytes the reference needs to compute
them again (``span``).  Each rank of a cell on several cards returns its
part of the window; ``merge`` joins the parts into one.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Checked:
    """One sampled stream-block: its capture, its step, the cu8 bytes of
    the sub-chunks ``span`` gives for it, and the program's outputs (field
    -> [n, ...] numpy) of the last n of them, from ``compare_from`` on."""
    capture: int
    step: int
    outputs: dict
    wire: np.ndarray
    compare_from: int


def span(block: int, k: int, quiet: np.ndarray, period: int,
         warm: int) -> tuple:
    """The sub-chunks that a check of block ``block`` (of ``k`` sub-chunks)
    covers, numbered from the capture's start: (first, compare_from).  The
    reference runs from ``first``; its outputs and the program's are
    compared from ``compare_from`` to the block's end.  ``compare_from``
    follows the last sub-chunk before the block that lies in a quiet gap
    (``quiet``: the capture's, modulo its ``period`` of sub-chunks), where
    the scanner detunes from any state; ``warm`` sub-chunks before it run
    the reference's filters in.  Before the first gap the check runs from
    the capture's start, where both sides start from the initial state."""
    g = block * k - 1
    i = int(np.searchsorted(quiet, g % period, "right")) - 1
    q = g - (g % period) + (int(quiet[i]) if i >= 0
                            else int(quiet[-1]) - period)
    if q < 0:
        return 0, 0
    return max(0, q + 1 - warm), q + 1


def wire_span(flat: np.ndarray, first: int, end: int,
              sub_bytes: int) -> np.ndarray:
    """Bytes of sub-chunks [first, end) of a circular capture ``flat``."""
    total = flat.shape[0]
    a, n = first * sub_bytes % total, (end - first) * sub_bytes
    parts = []
    while n > 0:
        take = min(n, total - a)
        parts.append(flat[a:a + take])
        a, n = 0, n - take
    return np.concatenate(parts)


def max_back(quiet: np.ndarray, period: int, k: int) -> int:
    """The most blocks that the compared sub-chunks of one check lie in."""
    d = np.diff(np.concatenate([quiet, quiet[:1] + period]))
    return int(-(-int(d.max()) // k)) + 1


@dataclasses.dataclass
class Window:
    setup_s: float                  # process start to the first timed block
    wall_s: float                   # first block taken to last output home
    samples: int                    # input samples whose outputs came home
    stream_blocks: int              # stream-blocks in the window
    latencies_s: list               # a block's take to its last output home
    step_s: float                   # host time inside the step calls,
    span_wall_s: float              # ... over this untraced part of the
    span_blocks: int                # window and its stream-blocks
    memory_peak_bytes: int
    checked: list                   # [Checked]
    trace: Optional[dict] = None    # trace.reduce(...) of the traced part
    trace_window_s: float = 0.0
    trace_blocks: int = 0           # stream-blocks dispatched in it
    incomplete: int = 0             # stream-blocks with no outputs home
    # a rank's part (``merge``): when its first block was taken and its
    # last output came home (time.perf_counter), and the entry's own counts
    # and seconds by name (a program's counters), for readers of its cell
    first_take_at: float = 0.0
    last_home_at: float = 0.0
    counters: dict = dataclasses.field(default_factory=dict)


def _summed(dicts: list) -> dict:
    """Numbers summed key by key, nested dicts likewise."""
    out: dict = {}
    for d in dicts:
        for key, value in d.items():
            if isinstance(value, dict):
                out[key] = _summed([out.get(key, {}), value])
            else:
                out[key] = out.get(key, 0) + value
    return out


def merge(parts: list, setup_s: float) -> Window:
    """One window of a cell's ranks' parts, which every per-layer reader
    reads as it reads one card's: per stream-block, over all cards.

    Summed: samples, stream-blocks, incomplete ones, the step calls' host
    time, the untraced part's wall time and blocks, the traced blocks and
    ``counters``.  ``wall_s`` runs from the earliest take on any rank to the
    latest output home on any rank; ``setup_s`` is given (the run's start
    to the window's common start).  Latencies are pooled, every rank's
    untraced part first, so the first ``span_blocks`` of them are the
    untraced part's of all ranks.  The fullest card's memory peak.  The
    checked stream-blocks of all ranks, each with its global capture index
    (two ranks may not check one capture's step).  Each rank traced its own
    card over the same stretch: the traces' numbers are summed (busy time,
    device time by part, by kernel and by idle gap), and so are their
    windows, the stretch times the cards, so that the idle share is the
    cards' mean.
    """
    if not parts:
        raise ValueError("no part to merge")
    for r, p in enumerate(parts):
        if not (p.first_take_at and p.last_home_at):
            raise ValueError(f"rank {r} stamped no first take or last home")
    traced = [p.trace is not None for p in parts]
    if any(traced) and not all(traced):
        raise ValueError(f"rank {traced.index(False)} recorded no trace, "
                         "others did")
    checked = sorted((c for p in parts for c in p.checked),
                     key=lambda c: (c.capture, c.step))
    keys = [(c.capture, c.step) for c in checked]
    if len(set(keys)) != len(keys):
        raise ValueError("two ranks checked the same capture's step")
    first = min(p.first_take_at for p in parts)
    last = max(p.last_home_at for p in parts)
    return Window(
        setup_s=setup_s, wall_s=last - first,
        samples=sum(p.samples for p in parts),
        stream_blocks=sum(p.stream_blocks for p in parts),
        latencies_s=([x for p in parts for x in p.latencies_s[:p.span_blocks]]
                     + [x for p in parts
                        for x in p.latencies_s[p.span_blocks:]]),
        step_s=sum(p.step_s for p in parts),
        span_wall_s=sum(p.span_wall_s for p in parts),
        span_blocks=sum(p.span_blocks for p in parts),
        memory_peak_bytes=max(p.memory_peak_bytes for p in parts),
        checked=checked,
        trace=_summed([p.trace for p in parts]) if all(traced) else None,
        trace_window_s=sum(p.trace_window_s for p in parts),
        trace_blocks=sum(p.trace_blocks for p in parts),
        incomplete=sum(p.incomplete for p in parts),
        first_take_at=first, last_home_at=last,
        counters=_summed([p.counters for p in parts]))


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from ``rng`` (Algorithm R)."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen = size, rng, 0
        self.items: list = []

    def offer(self, make) -> None:
        """Offer the next item; ``make(slot)`` builds it only if it is kept,
        for its slot."""
        i = self.seen
        self.seen += 1
        if i < self.size:
            self.items.append(make(i))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.size:
                self.items[j] = make(j)


def p95_ms(latencies_s: list) -> float:
    return float(np.percentile(np.asarray(latencies_s), 95)) * 1e3


class Stages:
    """Set-up's parts on the host clock, printed to standard error."""

    def __init__(self, t_start: float):
        self.marks = [("start", t_start)]

    def mark(self, name: str) -> float:
        now = time.perf_counter()
        self.marks.append((name, now))
        return now

    def log(self) -> None:
        parts = [f"{b[0]} {b[1] - a[1]:.3f} s"
                 for a, b in zip(self.marks, self.marks[1:])]
        print("setup: " + ", ".join(parts), file=sys.stderr, flush=True)

