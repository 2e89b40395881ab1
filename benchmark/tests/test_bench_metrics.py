"""The metric arithmetic on a synthetic trace and synthetic windows: the
idle share from the union of device intervals, the parts by kernel name,
roofline shares, the per-block host spans, and p95 over all blocks."""

import _paths  # noqa: F401

import numpy as np
import pytest

from benchlib import spec, trace, window, work

MS = 1_000_000          # ns


def ev(name, kind, a_ms, b_ms):
    return (name, kind, int(a_ms * MS), int(b_ms * MS))


#: a 10 ms traced window: K1 (with its DC carry), FSM glue, K2 (with its
#: carry), a copy; an overlap, two idle gaps inside harness spans
EVENTS = [
    ev("void fe_dc_local<0>(unsigned char const*, long long)", "device", 0, 1),
    ev("void dc_carry_kernel(float const*)", "device", 1, 1.5),
    ev("void fe_resample(float const*)", "device", 1.5, 2),
    ev("void pfb_filter(float const*)", "device", 2, 3),
    ev("at::native::vectorized_elementwise_kernel<4>", "device", 4, 5),
    ev("void ab_fir(float const*)", "device", 5, 6),
    ev("void dc_carry_kernel(float const*)", "device", 5.5, 6.5),
    ev("Memcpy DtoH (Device -> Pinned)", "device", 8, 9),
    ev("bench:dispatch", "annotation", 0, 9),
    ev("bench:dispatch", "host", 2.5, 4.5),
    ev("bench:drain", "host", 6.5, 8.5),
    ev("cudaGraphLaunch", "host", 2.6, 2.7),
]


def test_reduce_union_parts_and_gaps():
    r = trace.reduce(EVENTS)
    # busy = [0, 3] + [4, 6.5] + [8, 9] = 6.5 ms
    assert r["busy_s"] == pytest.approx(6.5e-3)
    assert r["parts_ms"]["K1"] == pytest.approx(3.0)
    assert r["parts_ms"]["K2"] == pytest.approx(2.0)
    assert r["parts_ms"]["copies"] == pytest.approx(1.0)
    assert r["parts_ms"]["other"] == pytest.approx(1.0)
    assert r["kernels_s"]["dc_carry_kernel"] == pytest.approx(1.5e-3)
    assert r["idle_by_span_s"] == {"bench:dispatch": pytest.approx(1e-3),
                                   "bench:drain": pytest.approx(1.5e-3)}
    assert r["device_events"] == 8


def test_window_readers():
    cfg = spec.config(spec.benchmark(), "pmr446_scan")
    w = window.Window(
        setup_s=10.0, wall_s=2.0, samples=4_000_000_000, stream_blocks=1000,
        latencies_s=list(np.linspace(0.1, 0.2, 101)) + [9.0] * 899,
        step_s=0.5, span_wall_s=1.5, span_blocks=101, memory_peak_bytes=0, checked=[],
        trace=trace.reduce(EVENTS), trace_window_s=0.010, trace_blocks=2)
    read = lambda name: spec.module("metrics", name).read(w, cfg, {})  # noqa
    assert read("device_idle_pct") == pytest.approx(35.0)
    assert read("k1_duo_roofline") == pytest.approx(
        100 * work.k1_bound_ms(cfg) * 2 / 3.0)
    assert read("k2_audio_bank_roofline") == pytest.approx(
        100 * work.k2_bound_ms(cfg) * 2 / 2.0)
    assert read("fsm_glue_device_ms_per_block") == pytest.approx(0.5)
    assert read("dispatch_host_ms_per_block") == pytest.approx(500 / 101)
    assert read("host_outside_step_ms_per_block") == pytest.approx(
        1000 / 101)
    # the untraced part's blocks alone
    assert read("block_latency_p95_ms") == pytest.approx(195.0)


def test_readers_find_nothing_without_a_trace_or_a_kernel():
    cfg = spec.config(spec.benchmark(), "pmr446_scan")
    w = window.Window(1.0, 1.0, 1, 1, [0.1], 0.0, 0.0, 0, 0, [])
    for name in ("device_idle_pct", "k1_duo_roofline",
                 "k2_audio_bank_roofline", "fsm_glue_device_ms_per_block",
                 "dispatch_host_ms_per_block",
                 "host_outside_step_ms_per_block", "block_latency_p95_ms"):
        assert spec.module("metrics", name).read(w, cfg, {}) is None
    w.trace = trace.reduce([ev("some_kernel", "device", 0, 1)])
    w.trace_window_s, w.trace_blocks = 0.002, 1
    for name in ("k1_duo_roofline", "k2_audio_bank_roofline"):
        assert spec.module("metrics", name).read(w, cfg, {}) is None


def test_p95_over_every_block():
    lat = [0.01] * 95 + [1.0] * 5
    assert window.p95_ms(lat) == pytest.approx(10.0 + 0.05 * 990.0)


def test_reservoir_is_uniform():
    rng = np.random.default_rng(1)
    counts = np.zeros(20)
    for _ in range(2000):
        r = window.Reservoir(3, rng)
        for i in range(20):
            r.offer(lambda slot, i=i: i)
        counts[r.items] += 1
    assert counts.min() > 200 and counts.max() < 400     # 300 expected
