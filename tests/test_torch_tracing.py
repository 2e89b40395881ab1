"""The port's span recorder and counters (utils/profiling.py) and where
the program takes them (runtime/driver.py, runtime/fuse.py, the scanner
CLI's --trace), on the CPU; one test on the card.

  - off, ``span`` is one shared no-op: nothing recorded, nothing
    allocated, and one block's spans and counters cost under 5 µs;
  - on: parents, the block a span concerns (given or inherited), self
    times, the cap on the spans kept;
  - the clock: a torch op run inside a span has its profiler event inside
    the span's interval;
  - a ScannerDriver run with the recorder on: each span a block or a
    dispatch makes, its block, and counters equal to what the result
    holds (``drain.waits_blocked`` 0 on the CPU); each drain's wait,
    fetch and loop once, in order, after the next dispatch; outputs bit
    for bit those of a run with it off;
  - the driver's ``ReadBack`` with the card's streams, events and pinned
    memory emulated: two staging buffers, fetched arrays equal to the
    outputs and owned by the caller, a drain that found its event
    pending counted;
  - a megastep's graph path (runtime/fuse.py ``_Captured``, its graph
    emulated on the CPU): warm-up and capture once, their stamps read by
    ``warmup_ms`` / ``capture_ms``, then stage / replay / collect a call;
  - ``--trace DIR``: the program's spans in DIR/trace.json beside the
    profiler's events, the counters in DIR/counters.json.
"""

import contextlib
import json
import time
import tracemalloc

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import iq as iq_io
from sdr_pmr446_tpu_torch.io import synth
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
from sdr_pmr446_tpu_torch.utils import profiling as P
from sdr_pmr446_tpu_torch.utils.profiling import count, span

torch.set_num_threads(2)

K, S, N_BLOCKS = 2, 2, 5        # two megasteps of 2 blocks, one tail step
FIELDS = ("audio", "audio_subchunks", "active_trace", "rssi_trace",
          "rel_rssi", "ct_detected", "ct_max_idx")


@pytest.fixture
def recorder():
    """The recorder on for the test, off after it whatever happens."""
    P.enable()
    try:
        yield
    finally:
        P.disable()


def by_name(snap) -> dict:
    out: dict = {}
    for s in snap.spans:
        out.setdefault(s.name, []).append(s)
    return out


def one_dispatch_of_spans(s: int = 8) -> None:
    """The spans and counters that a dispatch of ``s`` blocks makes on
    the card (runtime/driver.py, runtime/fuse.py), with empty bodies."""
    for b in range(s):
        with span("prefetch.source", b):
            pass
        with span("prefetch.slot_wait", b):
            pass
        with span("prefetch.host_copy", b):
            pass
        count("prefetch.bytes", 8_028_160)
        with span("prefetch.upload", b):
            pass
    with span("dispatch.stack", 0):
        pass
    with span("driver.dispatch", 0), span("megastep.call"):
        with span("megastep.stage"):
            pass
        with span("megastep.replay"):
            pass
        with span("megastep.collect"):
            pass
    count("driver.dispatches")
    count("driver.blocks", s)
    with span("drain.wait", 0):
        pass
    with span("drain.fetch", 0):
        pass
    with span("drain.subchunks", 0):
        P.enabled()
    count("drain.subchunks", 40 * s)
    count("drain.audio_subchunks", 0)
    count("drain.events", 0)


def test_span_off_records_and_allocates_nothing():
    P.enable()
    P.disable()
    assert not P.enabled()
    assert span("a", 1) is span("b") is span("c", None)
    one_dispatch_of_spans()             # warm
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(200):
            with span("prefetch.source", 7):
                pass
            with span("drain.wait"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, P.__file__)]
    grown = [d for d in after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno") if d.count_diff > 0]
    assert grown == []
    assert P.snapshot().spans == []


def test_span_off_costs_under_5_us_a_block():
    """One block's share of a dispatch's spans and counters at 8 blocks
    a dispatch, with the recorder off: the least of 7 repeats, in the
    thread's CPU time, under 5 µs (PERF.md gives the reading)."""
    one_dispatch_of_spans()
    per_block = []
    for _ in range(7):
        t = time.thread_time_ns()
        for _ in range(500):
            one_dispatch_of_spans()
        per_block.append((time.thread_time_ns() - t) / 500 / 8 / 1e3)
    assert min(per_block) < 5.0, per_block


def test_nesting_parents_self_time_block_and_cap(recorder):
    with span("outer", 3):
        time.sleep(0.002)
        with span("inner"):
            time.sleep(0.002)
            t = time.perf_counter_ns()
            P.record("summed", t - 1_000_000, t)
        with span("other", 5):
            pass
    with span("free"):
        pass
    snap = P.snapshot()
    names = [s.name for s in snap.spans]
    assert names == ["outer", "inner", "summed", "other", "free"]
    outer, inner, summed, other, free = snap.spans
    assert (inner.parent, summed.parent, other.parent, free.parent) == (
        0, 1, 0, -1)
    assert (outer.block, inner.block, summed.block, other.block,
            free.block) == (3, 3, 3, 5, None)
    dur = lambda s: s.end_ns - s.start_ns  # noqa: E731
    assert outer.self_ns == dur(outer) - dur(inner) - dur(other)
    assert inner.self_ns == dur(inner) - 1_000_000
    assert summed.self_ns == 1_000_000
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= other.start_ns
    assert other.end_ns <= outer.end_ns <= free.start_ns
    assert dur(outer) >= 4_000_000 and snap.dropped == 0
    # past the cap the first spans are kept and the rest counted
    P.enable(cap=2)
    with span("a", 1):
        with span("b"):
            with span("c"):
                pass
    with span("d"):
        pass
    snap = P.snapshot()
    assert [s.name for s in snap.spans] == ["a", "b"] and snap.dropped == 2
    assert snap.spans[0].self_ns == (snap.spans[0].end_ns
                                     - snap.spans[1].end_ns
                                     + snap.spans[1].start_ns
                                     - snap.spans[0].start_ns)


def test_spans_share_the_profilers_clock(recorder):
    """A torch op inside a span: its kineto event lies inside the span's
    interval, both on the Unix-epoch clock."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.arange(4096.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with span("around"):
                time.sleep(0.001)
                x.cumsum(0)
                time.sleep(0.001)
    spans = by_name(P.snapshot())["around"]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::cumsum"]
    assert len(ops) == len(spans) == 3
    for s, e in zip(spans, sorted(ops, key=lambda e: e.start_ns())):
        assert s.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns


@pytest.fixture(scope="module")
def capture():
    """cs16 wire: channel 5 with CTCSS 12 for 7 sub-chunks, then noise:
    N_BLOCKS blocks of K."""
    n1 = 7 * C.SUBCHUNK_IN
    n2 = (N_BLOCKS * K - 7) * C.SUBCHUNK_IN
    rng = np.random.default_rng(3)
    iq = np.concatenate([
        0.7 * synth.make_scanner_iq(n1, channel=5, ctcss_code=12),
        1e-3 * (rng.standard_normal(n2) + 1j * rng.standard_normal(n2))])
    from sdr_pmr446_tpu_torch.ops import decode
    return decode.quantize_iq(iq, "cs16")


def scan(raw, tmp, on_subchunk=None):
    drv = ScannerDriver(C.ScannerArgs(lock_mode="max"), subchunks_per_step=K,
                        input_format="cs16", device="cpu",
                        steps_per_dispatch=S, on_subchunk=on_subchunk,
                        checkpoint_path=str(tmp / "c.npz"),
                        checkpoint_every=1)
    blocks = list(wire_blocks(raw, "cs16", drv.feed_len))
    assert len(blocks) == N_BLOCKS
    return drv.run(blocks)


@pytest.fixture(scope="module")
def runs(capture, tmp_path_factory):
    """The driver with the recorder on (result, snapshot, counter deltas,
    sub-chunks seen by on_subchunk) and off (result)."""
    seen = []
    before = dict(P.COUNTS)
    P.enable()
    try:
        on = scan(capture, tmp_path_factory.mktemp("on"),
                  lambda sub, o: seen.append(sub))
    finally:
        P.disable()
    snap = P.snapshot()
    delta = {k: n - before[k] for k, n in P.COUNTS.items()}
    off = scan(capture, tmp_path_factory.mktemp("off"))
    return on, snap, delta, seen, off


def test_driver_spans_a_block_and_a_dispatch(runs):
    _, snap, _, seen, _ = runs
    spans = by_name(snap)
    blocks = lambda name: [s.block for s in spans.get(name, [])]  # noqa
    # every block's source next(), and the one that found the end
    assert blocks("prefetch.source") == [0, 1, 2, 3, 4, 5]
    assert blocks("dispatch.stack") == blocks("driver.dispatch") == [0, 2]
    assert blocks("megastep.call") == [0, 2]        # the CPU's: the loop
    assert blocks("step.eager") == [4]
    for name in ("drain.wait", "drain.fetch", "drain.subchunks",
                 "drain.on_subchunk"):
        assert blocks(name) == [0, 2, 4], name
    assert blocks("driver.checkpoint") == [2, 4, 5]
    assert seen == list(range(N_BLOCKS * K))
    assert not set(spans) & {               # the card's alone
        "megastep.stage", "megastep.replay", "megastep.collect",
        "megastep.warmup", "megastep.capture", "prefetch.slot_wait",
        "prefetch.pin", "prefetch.host_copy", "prefetch.upload"}
    for sub, cb in zip(spans["drain.subchunks"], spans["drain.on_subchunk"]):
        assert snap.spans[cb.parent] is sub
        assert sub.start_ns <= cb.start_ns <= cb.end_ns <= sub.end_ns
        assert sub.self_ns == (sub.end_ns - sub.start_ns
                               - (cb.end_ns - cb.start_ns))
    assert snap.dropped == 0


def test_driver_counters_are_exact(runs):
    on, _, delta, _, _ = runs
    assert delta["driver.blocks"] == N_BLOCKS
    assert delta["driver.dispatches"] == 3
    assert delta["driver.eager_steps"] == 1
    assert delta["drain.subchunks"] == N_BLOCKS * K
    assert delta["drain.audio_subchunks"] == len(on.audio_subchunks) > 0
    assert delta["drain.events"] == len(on.events) > 0
    assert delta["prefetch.bytes"] == delta["megastep.captures"] == 0


def test_driver_outputs_equal_with_the_recorder_on_and_off(runs):
    on, _, _, _, off = runs
    assert on.events == off.events
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(on, name), getattr(off, name))


def test_drain_waits_blocked_is_a_counter_and_reads_zero_on_the_cpu(runs):
    _, snap, delta, _, _ = runs
    assert "drain.waits_blocked" in snap.counters
    assert delta["drain.waits_blocked"] == 0


def test_each_drain_waits_fetches_and_loops_once_one_dispatch_behind(runs):
    """A drain's three spans, once each and in order, for the block it
    concerns, begun after the next dispatch (one behind); the card's
    read-back enqueue is not on the CPU's path."""
    _, snap, _, _, _ = runs
    spans = by_name(snap)
    assert "drain.enqueue" not in spans
    dispatches = spans["driver.dispatch"] + spans["step.eager"]
    for j, block in enumerate((0, 2, 4)):
        wait, fetch, loop = (
            [s for s in spans[name] if s.block == block]
            for name in ("drain.wait", "drain.fetch", "drain.subchunks"))
        assert len(wait) == len(fetch) == len(loop) == 1, block
        wait, fetch, loop = wait[0], fetch[0], loop[0]
        assert wait.end_ns <= fetch.start_ns <= fetch.end_ns \
            <= loop.start_ns, block
        if j + 1 < len(dispatches):
            assert dispatches[j + 1].end_ns <= wait.start_ns, block


class FakeEvent:
    """torch.cuda.Event on the CPU: ``query`` reads False while ``busy``
    is set, until a ``synchronize``."""
    busy = False

    def __init__(self):
        self.pending, self.synced = FakeEvent.busy, False

    def record(self, stream=None):
        pass

    def query(self):
        return not self.pending

    def synchronize(self):
        self.pending, self.synced = False, True


def fake_outputs(rng, k: int):
    """A StepOutputs of random values at ``k`` sub-chunks, the waterfall
    off ([k, 0])."""
    from sdr_pmr446_tpu_torch.scanner.chain import StepOutputs
    shapes = {"audio": (k, C.SUBCHUNK_AUDIO), "rssi_db": (k, C.NUM_CHANNELS),
              "waterfall": (k, 0)}
    fields = {}
    for f in StepOutputs._fields:
        shape = shapes.get(f, (k,))
        if f.startswith("ev_") and not f.endswith("chan") \
                or f in ("audio_valid", "ct_detected"):
            fields[f] = torch.from_numpy(rng.random(shape) < 0.5)
        elif f.endswith(("chan", "idx")):
            fields[f] = torch.from_numpy(
                rng.integers(-1, 16, shape).astype(np.int32))
        else:
            fields[f] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))
    return StepOutputs(**fields)


def test_read_back_staging_is_bounded_and_fetched_arrays_are_owned(
        monkeypatch):
    """ReadBack's card path with its streams and pinned memory emulated on
    the CPU, in the driver's order (start j + 1 before fetch j): each fetch
    equals the outputs read directly, field for field; two staging buffers
    serve megasteps and a smaller tail; what a fetch returned shares no
    memory with them and is unchanged after the buffer is reused; a drain
    whose event had not completed is counted and waits."""
    from sdr_pmr446_tpu_torch.runtime.driver import ReadBack
    from sdr_pmr446_tpu_torch.scanner.chain import outputs_to_numpy
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: None)
    allocated = []

    def staging(self, nbytes):
        allocated.append(torch.empty(nbytes, dtype=torch.uint8))
        return allocated[-1]

    monkeypatch.setattr(ReadBack, "_staging", staging)
    rng = np.random.default_rng(5)
    outs = [fake_outputs(rng, k) for k in (2 * K, 2 * K, 2 * K, K)]
    want = [outputs_to_numpy(o) for o in outs]
    rb = ReadBack(torch.device("cuda"))
    before = P.COUNTS["drain.waits_blocked"]
    got, held, tickets = [], [], []
    for j, out in enumerate(outs):
        FakeEvent.busy = j == 2
        tickets.append(rb.start(out, j))
        if j:
            rb.wait(tickets[j - 1])
            got.append(rb.fetch(tickets[j - 1]))
            held.append({f: a.copy() for f, a in got[-1].items()})
    FakeEvent.busy = False
    rb.wait(tickets[-1])
    got.append(rb.fetch(tickets[-1]))
    assert P.COUNTS["drain.waits_blocked"] == before + 1
    assert [t[3].synced for t in tickets] == [False, False, True, False]
    assert len(allocated) == ReadBack.SLOTS == 2
    for j, (g, w) in enumerate(zip(got, want)):
        assert list(g) == list(w)
        for f in w:
            assert g[f].dtype == w[f].dtype and g[f].shape == w[f].shape
            np.testing.assert_array_equal(g[f], w[f], err_msg=f"{j} {f}")
            assert not any(np.shares_memory(g[f], b.numpy())
                           for b in allocated), (j, f)
    for g, h in zip(got, held):
        for f in h:
            np.testing.assert_array_equal(g[f], h[f])


class EmulatedRecorder:
    """A CUDA graph recorder emulated on the CPU: a capture runs the body
    and keeps its outputs, a replay runs it again into them."""

    def __init__(self, stream):
        pass

    @staticmethod
    def _flat(result):
        state, outs = result
        return [state, *outs]

    def capture(self, fn):
        self.fn, self.result = fn, fn()
        return self.result

    def replay(self):
        for dst, src in zip(self._flat(self.result), self._flat(self.fn())):
            dst.copy_(src)


class NoStream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


def test_megastep_graph_path_spans(monkeypatch, recorder):
    monkeypatch.setattr(fuse, "CudaGraphRecorder", EmulatedRecorder)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: NoStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: NoStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())

    def step(state, x, gain):
        return state + x.sum(), x * gain

    xs, gain = torch.arange(6.0).reshape(2, 3), torch.tensor(2.0)
    captures = P.COUNTS["megastep.captures"]
    with span("driver.dispatch", 7):
        graph = fuse._Captured(step, 0, torch.zeros(()), xs, (gain,))
        for _ in range(2):
            st, out = graph(torch.ones(()), xs, (gain,))
    assert float(st) == 16.0 and torch.equal(out, (2 * xs).reshape(-1))
    assert P.COUNTS["megastep.captures"] == captures + 1
    snap = P.snapshot()
    assert [s.name for s in snap.spans] == [
        "driver.dispatch", "megastep.warmup", "megastep.capture",
        "megastep.stage", "megastep.replay", "megastep.collect",
        "megastep.stage", "megastep.replay", "megastep.collect"]
    assert all(s.parent == 0 and s.block == 7 for s in snap.spans[1:])
    warm, cap = snap.spans[1:3]
    assert graph.warmup_ms == (warm.end_ns - warm.start_ns) / 1e6
    assert graph.capture_ms == (cap.end_ns - cap.start_ns) / 1e6
    assert warm.end_ns == cap.start_ns


def test_app_trace_writes_program_spans_and_counters(tmp_path):
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    iq = 0.7 * synth.make_scanner_iq(4 * C.SUBCHUNK_IN, channel=5,
                                     ctcss_code=12)
    path = tmp_path / "cap.cs16"
    iq_io.write_iq(str(path), iq, "cs16")
    out = tmp_path / "tr"
    assert app.main(["--input", str(path), "--output",
                     str(tmp_path / "a.wav"), "--subchunks-per-step", "2",
                     "--steps-per-dispatch", "2", "--device", "cpu",
                     "--trace", str(out)]) == 0
    assert not P.enabled()
    with open(out / "trace.json") as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    program = [e for e in events if e.get("cat") == "program"]
    names = {e["name"] for e in program}
    assert {"prefetch.source", "dispatch.stack", "driver.dispatch",
            "drain.wait", "drain.fetch", "drain.subchunks"} <= names
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and all(e["ph"] == "X" and e["dur"] >= 0 for e in program)
    # one timeline: the spans cover the stack's aten::stack op
    stack = [e for e in program if e["name"] == "dispatch.stack"][0]
    assert any(e["name"] == "aten::stack"
               and stack["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= stack["ts"] + stack["dur"]
               for e in ops)
    with open(out / "counters.json") as f:
        counts = json.load(f)
    assert counts["counters"]["driver.blocks"] >= 2
    assert counts["spans"] == len(program) and counts["spans_dropped"] == 0
    assert set(P.COUNTS) <= set(counts["counters"])


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_driver_spans_on_card():
    """On the card at K = 8, S = 2, 5 blocks: the ring's spans a block,
    the megastep's a dispatch, one capture, the slot-wait counter within
    the waits, and outputs bit for bit those of a run with the recorder
    off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sdr_pmr446_tpu_torch.ops import decode
    dev = torch.device("cuda", 0)
    k, n = 8, 5
    iq = 0.7 * synth.make_scanner_iq(n * k * C.SUBCHUNK_IN, channel=5,
                                     ctcss_code=12)
    raw = decode.quantize_iq(iq, "cu8")
    results = []
    for on in (True, False):
        before = dict(P.COUNTS)
        drv = ScannerDriver(subchunks_per_step=k, device=dev,
                            steps_per_dispatch=2)
        with P.recording() if on else contextlib.nullcontext():
            results.append(drv.run(wire_blocks(raw, "cu8", drv.feed_len)))
        if on:
            snap = P.snapshot()
            delta = {c: v - before[c] for c, v in P.COUNTS.items()}
    spans = by_name(snap)
    for name in ("prefetch.host_copy", "prefetch.upload"):
        assert [s.block for s in spans[name]] == list(range(n)), name
    assert len(spans["prefetch.slot_wait"]) == n - 2
    assert delta["prefetch.slot_waits_blocked"] <= n - 2
    assert delta["prefetch.bytes"] == n * k * C.SUBCHUNK_IN * 2
    assert delta["megastep.captures"] == 1
    for name in ("megastep.call", "megastep.stage", "megastep.replay",
                 "megastep.collect"):
        assert [s.block for s in spans[name]] == [0, 2], name
    assert len(spans["megastep.warmup"]) == len(spans["megastep.capture"]) == 1
    assert [s.block for s in spans["step.eager"]] == [4]
    on, off = results
    assert on.events == off.events
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(on, name), getattr(off, name))
