"""Run one cell of the benchmark of the PyTorch / CUDA port.

    python3 benchmark/run.py --workload pmr446_scan.archive_s8 --seed 7 \\
        --seconds 30 --trace 0

Finds the cell in BENCHMARK.json, its configuration and its traffic mix by
name, makes the traffic from ``--seed`` on the card, runs the
configuration's entry (entries/<entry>.py: set-up, warm-up, then the
measured window of ``--seconds``), checks a sample of what the window
produced against the plain reference (references/<reference>.py), and
prints one JSON line as the last line of its standard output: ``correct``,
``attempted`` (stream-blocks handed in), ``failed`` (checked stream-blocks
outside a limit, and stream-blocks whose outputs never came home),
``metrics`` (with ``--trace 0`` the end-to-end metrics, with ``--trace 1``
the per-layer ones, each read by metrics/<name>.py), ``device``, with
``--trace 1`` ``breakdown``, and last ``checked``: each number compared
beside its limit, which also end its standard error.

A cell on one card runs its entry's ``run(cfg, mix, seed, seconds, trace,
device, t_start)`` in this process on ``cuda:0``.  A cell on P > 1 cards
runs as P ranks, one card each (``benchlib/ranks.py``): rank 0 here on
``cuda:0``, ranks 1 .. P-1 as child processes on ``cuda:1`` .. ``cuda:<P-1>``,
each in its entry's ``run_rank(rank, ranks, coordinator, cfg, mix, seed,
seconds, trace, device, t_start, start)``; their parts of the window are
merged into one (``window.merge``), checked and reported here.
``device.count`` is the number of distinct devices the ranks ran on and
``memory_peak_bytes`` the fullest one's peak.

It exits 2, printing no result, without a CUDA device or with fewer than
the cell's chips, 1 if a rank fails or the ranks outrun ``seconds`` plus
``ranks.SETUP_ALLOWANCE_S`` (every rank killed, the failing rank's last
output on standard error), and 3 if JAX or the JAX package is loaded in
any rank once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from benchlib import isolation, ranks, spec  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def verdict(reads: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}) for the worst readings."""
    checked, ok = {}, True
    for name, limit in limits.items():
        value = reads.get(name)
        checked[name] = {"value": value, "limit": limit}
        if value is not None and (not math.isfinite(value) or value > limit):
            ok = False
    return ok, checked


def check(cfg: dict, window, device) -> tuple:
    """Each sampled stream-block against the reference; returns (correct,
    checked, failed)."""
    ref_mod = spec.module("references", cfg["reference"])
    limits = cfg["limits"]
    reads, failed = [], 0
    for c in window.checked:
        ref = ref_mod.run(c.wire, c.compare_from, cfg, "f64", device)
        r = ref_mod.readings(c.outputs, ref)
        reads.append(r)
        failed += not verdict(r, limits)[0]
    ok, checked = verdict(ref_mod.worst(reads), limits)
    print(f"checked {len(reads)} stream-blocks against the reference, "
          f"{failed} outside a limit", file=sys.stderr)
    return ok and failed == 0 and window.incomplete == 0, checked, failed


def e2e_values(window) -> dict:
    return {"capture_msps": window.samples / window.wall_s / 1e6,
            "setup_s": window.setup_s}


def main(argv=None, device=None, overrides=None) -> int:
    """The run; returns its exit code.  ``device`` (tests only) skips the
    look for cards and runs every rank there: gloo ranks on the CPU, or a
    rehearsal of a cell's ranks on one card; ``overrides`` (tests only)
    updates the configuration and traffic mix: {"config": {...},
    "traffic": {...}}."""
    ns = parse(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, ns.workload)
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    if overrides:
        cfg.update(overrides.get("config", {}))
        mix.update(overrides.get("traffic", {}))
    import torch
    try:
        devices = ranks.devices(cell["chips"], device)
    except LookupError as e:
        print(f"{ns.workload}: {e}", file=sys.stderr)
        return 2
    entry = spec.module("entries", cfg["entry"])
    try:
        window, loaded = ranks.run(entry, cfg, mix, ns.seed, ns.seconds,
                                   bool(ns.trace), devices, T_START)
    except ranks.RankError as e:
        print(e, file=sys.stderr)
        return 1
    device = devices[0]
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": len({str(torch.device(d)) for d in devices}),
            "memory_peak_bytes": int(window.memory_peak_bytes)}
    correct, checked, failed = check(cfg, window, device)
    metrics, breakdown = {}, None
    if ns.trace:
        if window.trace is None:
            print("the traced run recorded no trace", file=sys.stderr)
            return 1
        info["busy_s"] = window.trace["busy_s"]
        info["window_s"] = window.trace_window_s
        for m in spec.metrics_of(bench, ns.workload, "per_layer"):
            value = spec.module("metrics", m["name"]).read(window, cfg, mix)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        from benchlib.trace import top
        breakdown = {"device_ops": top(window.trace["kernels_s"]),
                     "idle_gaps": top(window.trace["idle_by_span_s"])}
    else:
        values = e2e_values(window)
        for m in spec.metrics_of(bench, ns.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    bad = isolation.found() + loaded
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = {"correct": bool(correct),
            "attempted": int(window.stream_blocks),
            "failed": int(failed + window.incomplete),
            "metrics": metrics, "device": info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checked"] = checked
    for name, c in checked.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
