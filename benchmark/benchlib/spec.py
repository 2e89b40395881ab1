"""Cells, configurations, traffic mixes, entries and metric readers, found
by the names in BENCHMARK.json.

A cell names a configuration (its file is given in ``configs``), a
traffic mix (``traffic/<name>.json``) and its ``chips``; the configuration
names its entry (``entries/<entry>.py``, which drives the program) and its
reference (``references/<reference>.py``); a per-layer metric is
``metrics/<name>.py``.  Adding any of them is new files and new entries.

An entry of a cell on one card has ``run(cfg, mix, seed, seconds, trace,
device, t_start) -> window.Window``.  An entry of a cell on P > 1 cards
has ``run_rank(rank, ranks, coordinator, cfg, mix, seed, seconds, trace,
device, t_start, start) -> window.Window``, the part of rank ``rank`` on
its own card, which it measures from the common instant that ``start()``
returns after its warm-up; ``coordinator`` is a free ``127.0.0.1:<port>``
for the program's own rendezvous (``benchlib/ranks.py`` launches the ranks
and ``window.merge`` joins their parts).  The result's ``device.count`` is
the number of distinct devices the ranks ran on.  The tests' hook
(``run.main(..., device=...)``) runs every rank on that one device.

Every function takes the benchmark's folder (``bench``, by default this
one; the repository's root is its parent).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(bench: Path = BENCH_DIR) -> dict:
    return load_json(bench.parent / "BENCHMARK.json")


def _by_name(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(spec: dict, name: str) -> dict:
    return _by_name(spec["workloads"], name, "workload")


def config(spec: dict, name: str, bench: Path = BENCH_DIR) -> dict:
    entry = _by_name(spec["configs"], name, "configuration")
    return load_json(bench.parent / entry["file"])


def traffic(name: str, bench: Path = BENCH_DIR) -> dict:
    return load_json(bench / "traffic" / f"{name}.json")


def module(kind: str, name: str, bench: Path = BENCH_DIR):
    """``<kind>/<name>.py`` under the benchmark's folder, loaded by path
    (a metric's name may hold dots)."""
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {kind}/{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metrics_of(spec: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without ``workloads`` and those that list it."""
    return [m for m in spec[kind]
            if cell_name in m.get("workloads", [cell_name])]
