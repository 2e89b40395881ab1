"""A cell on several cards: the merge of the ranks' parts, read by every
per-layer reader per stream-block over all cards, and the launcher, run on
the CPU as four gloo ranks through ``run.main``'s device hook on a copy of
the benchmark with a throwaway four-chip cell added; a failing or hanging
rank ends the run non-zero in time and leaves no process.  The same run
with every rank on one card is ``-m cuda``."""

import _paths  # noqa: F401

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _throwaway
from benchlib import ranks, spec, window, work

SEED = 2 ** 31 + 91
CFG = spec.config(spec.benchmark(), "pmr446_scan")


def test_perf_counter_is_the_hosts_monotonic_clock():
    """Every process of the host reads one clock: a child's reading lies
    between two of this process's."""
    info = time.get_clock_info("perf_counter")
    assert info.implementation == "clock_gettime(CLOCK_MONOTONIC)"
    a = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c",
         "import time; print(repr(time.perf_counter()))"],
        capture_output=True, text=True, timeout=60, check=True)
    b = time.perf_counter()
    assert a < float(out.stdout) < b


def part(rank, trace=True):
    """A hand-made part of rank ``rank``: rank + 2 blocks, rank + 1 of them
    untraced."""
    n = rank + 2
    return window.Window(
        setup_s=99.0, wall_s=0.0, samples=1000 * (rank + 1), stream_blocks=n,
        latencies_s=[0.1 * (rank + 1) + 0.01 * i for i in range(n)],
        step_s=0.1 * (rank + 1), span_wall_s=0.5 * (rank + 1),
        span_blocks=rank + 1, memory_peak_bytes=[300, 700, 500][rank],
        checked=[window.Checked(2 * rank + i, i, {}, np.zeros(1), 0)
                 for i in range(2)],
        trace=({"busy_s": 0.2 * (rank + 1),
                "parts_ms": {"K1": 1.0 + rank, "K2": 0.5, "copies": 0.1,
                             "other": 2.0 * (rank + 1)},
                "kernels_s": {"duo": 0.001, f"k{rank}": 0.002},
                "idle_by_span_s": {"bench:drain": 0.01 * (rank + 1)},
                "device_events": 10} if trace else None),
        trace_window_s=1.0 if trace else 0.0,
        trace_blocks=rank + 1 if trace else 0, incomplete=rank % 2,
        first_take_at=50.0 + 0.01 * rank,
        last_home_at=[51.0, 51.5, 51.2][rank],
        counters={"collectives": 2, "gloo": {"bytes": 10 * (rank + 1)}})


def test_merge_sums_pools_and_takes_the_fullest_card():
    w = window.merge([part(2), part(0), part(1)], setup_s=7.5)
    assert w.setup_s == 7.5
    assert w.wall_s == pytest.approx(1.5)          # 51.5 - 50.0
    assert (w.samples, w.stream_blocks, w.incomplete) == (6000, 9, 1)
    assert (w.span_blocks, w.trace_blocks) == (6, 6)
    assert w.step_s == pytest.approx(0.6)
    assert w.span_wall_s == pytest.approx(3.0)
    assert w.memory_peak_bytes == 700
    # every rank's untraced part first, then the rest
    assert w.latencies_s == pytest.approx(
        [0.3, 0.31, 0.32, 0.1, 0.2, 0.21] + [0.33, 0.11, 0.22])
    assert [(c.capture, c.step) for c in w.checked] == [
        (c, c % 2) for c in range(6)]
    assert w.trace["busy_s"] == pytest.approx(1.2)
    assert w.trace_window_s == 3.0
    assert w.trace["parts_ms"] == pytest.approx(
        {"K1": 6.0, "K2": 1.5, "copies": 0.3, "other": 12.0})
    assert w.trace["kernels_s"] == pytest.approx(
        {"duo": 0.003, "k0": 0.002, "k1": 0.002, "k2": 0.002})
    assert w.trace["idle_by_span_s"] == pytest.approx({"bench:drain": 0.06})
    assert w.trace["device_events"] == 30
    assert w.counters == {"collectives": 6, "gloo": {"bytes": 60}}


def test_every_reader_reads_the_merge_per_block_over_all_cards():
    w = window.merge([part(0), part(1), part(2)], setup_s=1.0)
    read = lambda name: spec.module("metrics", name).read(w, CFG, {})  # noqa
    # busy 1.2 s of 3 card-seconds
    assert read("device_idle_pct") == pytest.approx(60.0)
    # 6 traced blocks: K1 6 ms, K2 1.5 ms, the rest 12 ms
    assert read("k1_duo_roofline") == pytest.approx(
        100 * work.k1_bound_ms(CFG) * 6 / 6.0)
    assert read("k2_audio_bank_roofline") == pytest.approx(
        100 * work.k2_bound_ms(CFG) * 6 / 1.5)
    assert read("fsm_glue_device_ms_per_block") == pytest.approx(2.0)
    # 6 untraced blocks: 0.6 s in the step calls, 3.0 s of wall
    assert read("dispatch_host_ms_per_block") == pytest.approx(100.0)
    assert read("host_outside_step_ms_per_block") == pytest.approx(400.0)
    # the 6 untraced blocks' latencies: 0.1, 0.2, 0.21, 0.3, 0.31, 0.32
    assert read("block_latency_p95_ms") == pytest.approx(
        np.percentile([0.1, 0.2, 0.21, 0.3, 0.31, 0.32], 95) * 1e3)


def test_merge_refuses_parts_that_do_not_fit():
    with pytest.raises(ValueError, match="rank 1 recorded no trace"):
        window.merge([part(0), part(1, trace=False)], 1.0)
    twin = part(1)
    twin.checked = part(0).checked
    with pytest.raises(ValueError, match="same capture"):
        window.merge([part(0), twin], 1.0)
    unstamped = part(1)
    unstamped.first_take_at = 0.0
    with pytest.raises(ValueError, match="rank 1 stamped"):
        window.merge([part(0), unstamped], 1.0)


def test_one_card_runs_the_entry_in_this_process(tmp_path):
    """A cell on one card: the entry's ``run``, called as it always was."""
    calls = []

    class Entry:
        @staticmethod
        def run(*args):
            calls.append(args)
            return "the window"

    got = ranks.run(Entry, {}, {"m": 1}, 5, 1.0, True, ["cuda:0"], 3.0)
    assert got == ("the window", [])
    assert calls == [({}, {"m": 1}, 5, 1.0, True, "cuda:0", 3.0)]


def test_devices_hook_and_cards():
    assert ranks.devices(4, "cpu") == ["cpu"] * 4
    assert ranks.devices(1, "cuda:0") == ["cuda:0"]
    if not torch.cuda.is_available():
        with pytest.raises(LookupError, match="no CUDA device"):
            ranks.devices(4)


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark with the throwaway four-chip cell added."""
    bench = _throwaway.copy_benchmark(tmp_path)
    spec_json = json.loads((tmp_path / "BENCHMARK.json").read_text())
    _throwaway.add_four_chip_cell(bench, spec_json)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_json))
    (tmp_path / "pids").mkdir()
    return bench


def run_main(bench, trace=0, device="cpu", seconds=1, traffic=None,
             allowance=None, unwind=None):
    """``run.main`` of the copy, in a process of its own, on ``device``:
    (exit code, stdout lines, stderr, seconds taken)."""
    traffic = dict(traffic or {}, pid_dir=str(bench.parent / "pids"))
    argv = ["--workload", _throwaway.CELL, "--seed", str(SEED), "--seconds",
            str(seconds), "--trace", str(trace)]
    code = [f"import sys; sys.path[:0] = [{str(bench)!r}]",
            "import run", "from benchlib import ranks"]
    if allowance is not None:
        code.append(f"ranks.SETUP_ALLOWANCE_S = {allowance!r}")
    if unwind is not None:
        code.append(f"ranks.UNWIND_S = {unwind!r}")
    code.append(f"sys.exit(run.main({argv!r}, device={device!r}, "
                f"overrides={{'traffic': {traffic!r}}}))")
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", "\n".join(code)],
                         cwd=bench.parent, capture_output=True, text=True,
                         timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    return (out.returncode, out.stdout.strip().splitlines(), out.stderr,
            time.perf_counter() - t)


def ready_s(err):
    """When the last rank was ready, seconds after the run's start, as the
    launcher logs it."""
    line = next(s for s in err.splitlines() if s.startswith("ranks:"))
    return float(re.search(r"([0-9.]+) s after the run's start", line)[1])


def alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def assert_no_rank_left(bench, n=_throwaway.CHIPS):
    pids = {p.name: int(p.read_text())
            for p in (bench.parent / "pids").iterdir()}
    assert len(pids) == n, pids
    deadline = time.monotonic() + 10
    while any(alive(p) for p in pids.values()) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not [r for r, p in pids.items() if alive(p)]


def numbers(bench):
    """Each rank's numbers, as the throwaway entry gives them."""
    entry = spec.module("entries", _throwaway.NAME, bench)
    return [entry.numbers(r) for r in range(_throwaway.CHIPS)]


def test_four_gloo_ranks_merged_into_one_line(copy):
    rc, out, err, _ = run_main(copy)
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    k = numbers(copy)
    wall = max(n["last_home"] for n in k) - min(n["first_take"] for n in k)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == sum(n["stream_blocks"] for n in k) == 14
    assert line["metrics"]["capture_msps"]["value"] == pytest.approx(
        sum(n["samples"] for n in k) / wall / 1e6)
    # the run's start to the common start: the launch and the barrier
    assert line["metrics"]["setup_s"]["value"] == pytest.approx(
        ready_s(err) + ranks.START_MARGIN_S, abs=0.01)
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 400}
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checked"]
    assert line["checked"] == {"gap": {"value": 0.0, "limit": 0.0}}
    assert "checked 8 stream-blocks against the reference" in err
    assert "ranks: 4 on cpu, cpu, cpu, cpu" in err
    assert_no_rank_left(copy)


def test_four_ranks_traced(copy):
    rc, out, err, _ = run_main(copy, trace=1)
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    k = numbers(copy)
    busy = sum(n["trace"]["busy_s"] for n in k)
    assert line["device"]["busy_s"] == pytest.approx(busy)
    assert line["device"]["window_s"] == pytest.approx(4.0)
    m = {name: v["value"] for name, v in line["metrics"].items()}
    assert m["device_idle_pct"] == pytest.approx(100 * (1 - busy / 4.0))
    blocks = sum(n["trace_blocks"] for n in k)
    assert m["fsm_glue_device_ms_per_block"] == pytest.approx(
        sum(n["trace"]["parts_ms"]["other"] for n in k) / blocks)
    span = sum(n["span_blocks"] for n in k)
    assert m["dispatch_host_ms_per_block"] == pytest.approx(
        sum(n["step_s"] for n in k) * 1e3 / span)
    assert m["block_latency_p95_ms"] == pytest.approx(np.percentile(
        [x for n in k for x in n["latencies_s"][:n["span_blocks"]]], 95) * 1e3)
    ops = dict(line["breakdown"]["device_ops"])
    assert {f"only_rank{r}" for r in range(4)} <= set(ops)
    assert ops["duo_main"] == pytest.approx(0.010)
    assert line["correct"] is True


def test_an_answer_altered_on_one_rank_is_not_correct(copy):
    rc, out, err, _ = run_main(copy, traffic={"alter": 3})
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    assert line["correct"] is False and line["failed"] == 1
    assert line["checked"]["gap"]["value"] == 1.0


@pytest.mark.parametrize("rank,how", [(2, "raise"), (1, "raise_warm"),
                                      (0, "raise"), (3, "sleep"),
                                      (0, "sleep")])
def test_a_failing_or_hanging_rank_ends_the_run(copy, rank, how):
    """Every rank killed, a non-zero exit within the window plus the
    allowance (and rank 0's unwinding), the failing rank's error last, no
    result."""
    allowance, unwind, seconds = 20.0, 2.0, 1
    rc, out, err, took = run_main(copy, seconds=seconds, allowance=allowance,
                                  unwind=unwind,
                                  traffic={"fail": {"rank": rank, "how": how}})
    assert rc != 0
    assert not out or not out[-1].startswith("{")
    assert took < seconds + allowance + unwind + 15
    if how == "sleep":
        assert f"(still running: rank {rank})" in err and took > allowance
    else:
        assert f"rank {rank} broke" in err and took < allowance
    assert_no_rank_left(copy)


def test_a_missing_run_rank_fails_at_once(copy):
    (copy / "entries" / f"{_throwaway.NAME}.py").write_text(
        "def run(*args):\n    raise AssertionError\n")
    rc, out, err, took = run_main(copy)
    assert rc == 1 and not out
    assert "has no run_rank" in err


def test_calibrate_runs_the_ranks_of_each_seed(copy):
    """calibrate.py on the four-chip cell: each seed's window from the four
    ranks, every rank's checked stream-blocks compared."""
    pids = str(copy.parent / "pids")
    code = (f"import sys; sys.path[:0] = [{str(copy)!r}]\n"
            "import calibrate\n"
            f"sys.exit(calibrate.main(['--workload', {_throwaway.CELL!r}, "
            "'--seconds', '1', '--seeds', '5', '6'], device='cpu', "
            f"overrides={{'traffic': {{'pid_dir': {pids!r}}}}}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy.parent,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert [r["seed"] for r in rows[:2]] == [5, 6]
    for row in rows[:2]:
        assert row["blocks"] == 8 and row["subchunks"] == [64] * 8
        assert row["program"] == {"gap": 0.0}
    assert rows[2]["summary"]["program"]["gap"]["max"] == 0.0
    assert_no_rank_left(copy)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_four_ranks_rehearsed_on_one_card(copy, trace):
    """The throwaway cell's four ranks through the hook, all on cuda:0:
    the merged line, the launch in ``setup_s``, no process left."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (four ranks on one card)")
    rc, out, err, took = run_main(copy, device="cuda:0", trace=trace)
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    print(json.dumps(line))
    print("\n".join(s for s in err.splitlines() if s.startswith("ranks:")))
    print(f"the run took {took:.3f} s")
    if not trace:
        assert line["metrics"]["setup_s"]["value"] == pytest.approx(
            ready_s(err) + ranks.START_MARGIN_S, abs=0.01)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    assert line["device"]["memory_peak_bytes"] >= 4 << 20
    assert_no_rank_left(copy)
