"""A throwaway cell on four cards, added to a copy of the benchmark with new
files and new entries alone: a configuration (the scanner's sizes, which
the readers take, with an entry and a reference of its own), a traffic mix,
and an entry whose ``run_rank`` joins a gloo group at the coordinator, does
one all_gather, waits for the common start and hands back a part of the
window with known numbers (``numbers``)."""

import json
import shutil

from benchlib import spec

NAME = "ranks_probe"
CELL = f"{NAME}.{NAME}"
CHIPS = 4

ENTRY = '''"""Entry of a throwaway cell on several cards: known numbers."""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from benchlib import window as W


def numbers(rank):
    """Rank ``rank``'s part: what it would have measured."""
    n = rank + 2
    return {
        "stream_blocks": n, "span_blocks": rank + 1,
        "samples": 1000 * (rank + 1),
        "latencies_s": [0.01 * (rank + 1) + 0.001 * i for i in range(n)],
        "step_s": 0.1 * (rank + 1), "span_wall_s": 0.5 * (rank + 1),
        "memory_peak_bytes": 100 * (rank + 1),
        "first_take": 0.001 * rank, "last_home": 1.0 + 0.1 * rank,
        "trace": {"busy_s": 0.2 * (rank + 1),
                  "parts_ms": {"K1": 1.0 + rank, "K2": 0.5, "copies": 0.1,
                               "other": 2.0 * (rank + 1)},
                  "kernels_s": {"duo_main": 0.001 * (rank + 1),
                                f"only_rank{rank}": 0.002},
                  "idle_by_span_s": {"bench:drain": 0.01 * (rank + 1)},
                  "device_events": 10},
        "trace_window_s": 1.0, "trace_blocks": rank + 1,
        "counters": {"collectives": 1},
    }


def wire(seed, rank, i):
    rng = np.random.default_rng([seed, rank, i])
    return rng.integers(0, 256, 64).astype(np.uint8)


def run_rank(rank, ranks, coordinator, cfg, mix, seed, seconds, trace,
             device, t_start, start):
    if mix.get("pid_dir"):
        with open(os.path.join(mix["pid_dir"], str(rank)), "w") as f:
            f.write(str(os.getpid()))
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=ranks, rank=rank)
    try:
        got = [torch.zeros(1, dtype=torch.int64) for _ in range(ranks)]
        dist.all_gather(got, torch.tensor([rank]))
    finally:
        dist.destroy_process_group()
    if [int(g) for g in got] != list(range(ranks)):
        raise RuntimeError(f"all_gather gave {got}")
    fail = mix.get("fail") or {}
    if fail.get("rank") == rank and fail["how"] == "raise_warm":
        raise RuntimeError(f"rank {rank} broke in its warm-up")
    t0 = start()
    if fail.get("rank") == rank and fail["how"] == "raise":
        raise RuntimeError(f"rank {rank} broke after its warm-up")
    if fail.get("rank") == rank and fail["how"] == "sleep":
        time.sleep(3600)
    k = numbers(rank)
    memory = k["memory_peak_bytes"]
    if torch.device(device).type == "cuda":
        x = torch.ones((rank + 1) << 18, device=device)     # (rank + 1) MiB
        torch.cuda.synchronize(device)
        memory = torch.cuda.max_memory_allocated(device)
        del x
    while time.perf_counter() < t0 + seconds:
        time.sleep(0.01)
    checked = []
    for i in range(2):
        w = wire(seed, rank, i)
        x = w * 2.0
        if mix.get("alter") == rank and i == 1:
            x[3] += 1.0
        checked.append(W.Checked(2 * rank + i, i, {"x": x}, w, 0))
    first, last = t0 + k["first_take"], t0 + k["last_home"]
    return W.Window(
        setup_s=t0 - t_start, wall_s=last - first, samples=k["samples"],
        stream_blocks=k["stream_blocks"], latencies_s=k["latencies_s"],
        step_s=k["step_s"], span_wall_s=k["span_wall_s"],
        span_blocks=k["span_blocks"], memory_peak_bytes=memory,
        checked=checked, trace=dict(k["trace"]) if trace else None,
        trace_window_s=k["trace_window_s"] if trace else 0.0,
        trace_blocks=k["trace_blocks"] if trace else 0,
        first_take_at=first, last_home_at=last, counters=k["counters"])
'''

REFERENCE = '''"""Reference of the throwaway cell: twice the wire."""

import numpy as np

WARM_SUBCHUNKS = 0


def run(wire, compare_from, cfg, precision, device):
    return {"x": wire.astype(np.float64) * 2.0}


def readings(outputs, ref):
    return {"gap": float(np.abs(outputs["x"] - ref["x"]).max())}


def worst(reads):
    return {"gap": max(r["gap"] for r in reads)}
'''


def copy_benchmark(dest):
    """The benchmark's folder (without its tests) and BENCHMARK.json copied
    into ``dest``; returns the copy's folder."""
    bench = dest / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.BENCH_DIR.parent / "BENCHMARK.json", dest)
    return bench


def add_four_chip_cell(bench, bench_json):
    """The cell's new files under ``bench``, its new entries appended to
    ``bench_json`` (BENCHMARK.json as a dict); returns the cell's name."""
    cfg = dict(spec.config(spec.benchmark(), "pmr446_scan"), name=NAME,
               entry=NAME, reference=NAME, limits={"gap": 0.0})
    (bench / "configs" / f"{NAME}.json").write_text(json.dumps(cfg))
    (bench / "traffic" / f"{NAME}.json").write_text(json.dumps(
        {"name": NAME, "why": "known numbers a rank", "check_blocks": 2}))
    (bench / "entries" / f"{NAME}.py").write_text(ENTRY)
    (bench / "references" / f"{NAME}.py").write_text(REFERENCE)
    bench_json["configs"].append({
        "name": NAME, "source": "x", "file": f"benchmark/configs/{NAME}.json",
        "reduced": [], "why": "x"})
    bench_json["workloads"].append({
        "name": CELL, "config": NAME, "traffic": NAME, "chips": CHIPS,
        "why": "x"})
    return CELL
