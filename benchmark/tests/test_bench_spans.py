"""The readings of the program's spans (benchlib/spans.py) on synthetic
spans and events: ``reduce`` without spans is ``trace.reduce``, and with
them renames the idle gaps alone; the host's self times over a window;
the device time launched from inside given spans, matched by correlation
id, with the share of device time whose launch was found; the first
megastep's warm-up and capture; the correlation ids kept beside the
tracer's events."""

import _paths  # noqa: F401

import pytest
import torch

from benchlib import spans as S
from benchlib import trace

MS = 1_000_000          # ns


def ev(name, kind, a_ms, b_ms):
    return (name, kind, int(a_ms * MS), int(b_ms * MS))


def sp(name, a_ms, b_ms, self_ms=None, block=0):
    """A program span (name, start, end, self, block)."""
    a, b = int(a_ms * MS), int(b_ms * MS)
    return (name, a, b, b - a if self_ms is None else int(self_ms * MS),
            block)


#: a 12 ms stretch: a dispatch's stack, stage, replay, collect, a drain's
#: wait, fetch and loop, the ring's copy outside both; idle gaps at 1-2,
#: 3-4, 6-6.5, 7-8, 9-10 and 11-11.5
EVENTS = [
    ev("at::native::CatArrayBatchedCopy", "device", 0.5, 1),
    ev("at::native::elementwise_kernel", "device", 2, 3),       # stage
    ev("void fe_resample(float const*)", "device", 4, 5),       # replay
    ev("at::native::CatArrayBatchedCopy", "device", 5, 6),      # collect
    ev("Memcpy DtoH (Device -> Pageable)", "device", 6.5, 7),   # fetch
    ev("Memcpy HtoD (Pinned -> Device)", "device", 8, 9),       # upload
    ev("some_kernel_without_launch", "device", 10, 11),
    ev("unmatched_tail", "device", 11.5, 12),
    ev("bench:dispatch", "host", 1.8, 6),
    ev("bench:drain", "host", 6.2, 8.2),
    ev("aten::cat", "host", 0.1, 0.15),
    ev("cudaLaunchKernel", "host", 0.2, 0.3),
    ev("cudaLaunchKernel", "host", 1.9, 2.0),
    ev("cudaGraphLaunch", "host", 3.9, 4.0),
    ev("cudaLaunchKernel", "host", 4.5, 4.6),
    ev("cudaMemcpyAsync", "host", 6.35, 6.4),
    ev("cudaMemcpyAsync", "host", 7.9, 8.0),
]
#: kineto correlation ids, in the order of EVENTS (0: none); the CPU op
#: aten::cat shares id 14 with a device event and must not count
CORR = [11, 12, 13, 14, 15, 16, 99, 0, 0, 0, 14, 11, 12, 13, 14, 15, 16]

SPANS = [
    sp("dispatch.stack", 0, 1.2),
    sp("driver.dispatch", 1.7, 6.1, self_ms=0.4),
    sp("megastep.stage", 1.85, 3.6),
    sp("megastep.replay", 3.8, 4.2),
    sp("megastep.collect", 4.3, 5.8),
    sp("drain.wait", 6.25, 6.3),
    sp("drain.fetch", 6.3, 6.45),
    sp("drain.subchunks", 6.5, 8.1, self_ms=1.2),
    sp("drain.on_subchunk", 7.7, 8.1),
    sp("prefetch.host_copy", 8.5, 10.5, block=8),
    sp("prefetch.upload", 7.85, 8.05, block=9),
    sp("megastep.warmup", 20, 2020),
    sp("megastep.capture", 2020, 2500),
    sp("megastep.warmup", 3000, 3100),
]


def test_reduce_without_spans_is_trace_reduce():
    assert S.reduce(EVENTS, "x") == trace.reduce(EVENTS, "x")


def test_reduce_with_spans_renames_the_idle_gaps_only():
    plain = trace.reduce(EVENTS, "outside")
    named = S.reduce(EVENTS, "outside", SPANS)
    assert set(named) == set(plain)
    for key in plain:
        if key != "idle_by_span_s":
            assert named[key] == plain[key], key
    assert sum(named["idle_by_span_s"].values()) == pytest.approx(
        sum(plain["idle_by_span_s"].values()))
    assert plain["idle_by_span_s"] == {
        "outside": pytest.approx(2.5e-3),         # 1-2, 9-10, 11-11.5
        "bench:dispatch": pytest.approx(1e-3),    # 3-4
        "bench:drain": pytest.approx(1.5e-3)}     # 6-6.5, 7-8
    # each gap by the innermost span over its middle: the program's nest
    # inside the harness's and win; a gap under none stays ``outside``
    assert named["idle_by_span_s"] == {
        "outside": pytest.approx(1.5e-3),         # 1-2, 11-11.5
        "megastep.stage": pytest.approx(1e-3),    # 3-4
        "drain.wait": pytest.approx(0.5e-3),      # 6-6.5
        "drain.subchunks": pytest.approx(1e-3),   # 7-8
        "prefetch.host_copy": pytest.approx(1e-3)}  # 9-10


def test_idle_gaps_are_trace_reduces():
    gaps = S.idle_gaps(EVENTS)
    assert gaps == [(1 * MS, 2 * MS), (3 * MS, 4 * MS), (6 * MS, 6.5 * MS),
                    (7 * MS, 8 * MS), (9 * MS, 10 * MS),
                    (11 * MS, 11.5 * MS)]
    assert sum(b - a for a, b in gaps) / 1e9 == pytest.approx(
        sum(trace.reduce(EVENTS)["idle_by_span_s"].values()))


def test_self_ms_inside_a_window():
    assert S.self_ms(SPANS, ("drain.subchunks",), 0, 9 * MS) == 1.2
    assert S.self_ms(SPANS, S.COPIES, 0, 6 * MS) == pytest.approx(
        1.2 + 1.75 + 1.5)
    # a span that ends past the window's end is left out
    assert S.self_ms(SPANS, ("prefetch.host_copy",), 0, 10 * MS) == 0
    assert S.self_ms(SPANS, ("prefetch.host_copy",), 8 * MS,
                     11 * MS) == 2.0


def test_launched_ms_by_correlation():
    ms, found = S.launched_ms(EVENTS, CORR, SPANS, S.COPIES)
    # the stack's cat (0.5), the stage's copy (1), the collect's cat (1)
    assert ms == pytest.approx(2.5)
    total = 0.5 + 1 + 1 + 1 + 0.5 + 1 + 1 + 0.5
    assert found == pytest.approx((total - 1.5) / total)
    assert S.launched_ms(EVENTS, CORR, SPANS, ("megastep.replay",))[0] == 1
    assert S.launched_ms(EVENTS, CORR, SPANS, ("drain.fetch",))[0] == 0.5
    assert S.launched_ms(EVENTS, CORR, SPANS, ("prefetch.upload",))[0] == 1
    assert S.launched_ms([], [], SPANS, S.COPIES) == (0.0, 0.0)


def test_runtime_calls():
    assert S.runtime_call("cudaLaunchKernel")
    assert S.runtime_call("cuLaunchKernelEx")
    assert not S.runtime_call("aten::cat")
    assert not S.runtime_call("cudnn_convolution")


def test_first_dispatch_s():
    assert S.first_dispatch_s(SPANS) == pytest.approx(2.48)
    assert S.first_dispatch_s(SPANS[:11]) is None
    assert S.first_dispatch_s([]) is None


def test_correlated_tracer_keeps_an_id_for_each_event(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    tracer = S.CorrelatedTracer("cpu")
    tracer.begin()
    torch.arange(64.0).cumsum(0)
    tracer.end()
    assert tracer.events and len(tracer.correlation) == len(tracer.events)
    assert all(isinstance(c, int) for c in tracer.correlation)


def test_program_spans_from_a_snapshot():
    from sdr_pmr446_tpu_torch.utils import profiling as P
    with P.recording():
        with P.span("drain.wait", 4):
            pass
    (s,) = P.snapshot().spans
    assert S.program_spans(P.snapshot()) == [
        ("drain.wait", s.start_ns, s.end_ns, s.self_ns, 4)]
