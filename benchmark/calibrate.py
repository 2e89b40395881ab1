"""The readings that a cell's limits are set from (not part of a run).

    python3 benchmark/calibrate.py --workload pmr446_scan.archive_s8 \\
        --seconds 10 --seeds 11 12 13 ... [--plant fsm_carry_reset]

For each seed, in one process: the cell's entry runs a window of
``--seconds`` (the cell's own sizes and load), then every sampled
stream-block is compared with the reference two ways:

  - ``program``: the program's outputs (the lower readings); with
    ``--plant``, those of the program with a fault of
    ``benchlib/faults.py`` planted in its timed path;
  - ``control``: the reference computed in the precision below the
    configuration's (float32 with TF32 operands) in the program's place
    (the upper readings).

Prints one JSON line a seed and a summary: each number's largest and
smallest reading of each kind.  Runs on the card (or, for the tests,
wherever ``main``'s ``device`` says).  A cell on several cards runs each
seed's window as its ranks, one card each, as run.py does
(``benchlib/ranks.py``, the fault planted in every rank), and compares the
merged window's checked stream-blocks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from benchlib import faults, ranks, spec  # noqa: E402


def main(argv=None, device=None, overrides=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--plant", choices=sorted(faults.FAULTS))
    ns = p.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, ns.workload)
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    if overrides:
        cfg.update(overrides.get("config", {}))
        mix.update(overrides.get("traffic", {}))
    try:
        devices = ranks.devices(cell["chips"], device)
    except LookupError as e:
        print(e, file=sys.stderr)
        return 2
    undo = faults.plant(ns.plant) if ns.plant else None
    try:
        return _seeds(ns, cfg, mix, devices)
    finally:
        if undo:
            undo()


def _seeds(ns, cfg: dict, mix: dict, devices: list) -> int:
    entry = spec.module("entries", cfg["entry"])
    ref_mod = spec.module("references", cfg["reference"])
    device = devices[0]
    summary: dict = {}
    for seed in ns.seeds:
        window, _ = ranks.run(entry, cfg, mix, seed, ns.seconds, False,
                              devices, time.perf_counter(), ns.plant)
        kinds: dict = {"program": [], "control": []}
        ref_s = 0.0
        for c in window.checked:
            t0 = time.perf_counter()
            ref = ref_mod.run(c.wire, c.compare_from, cfg, "f64", device)
            ref_s += time.perf_counter() - t0
            kinds["program"].append(ref_mod.readings(c.outputs, ref))
            ctl = ref_mod.run(c.wire, c.compare_from, cfg, "tf32", device)
            kinds["control"].append(ref_mod.readings(ctl, ref))
        row = {"seed": seed, "blocks": len(window.checked),
               "subchunks": [len(next(iter(c.outputs.values())))
                             for c in window.checked],
               "msps": window.samples / window.wall_s / 1e6,
               "reference_s": ref_s}
        for kind, reads in kinds.items():
            row[kind] = ref_mod.worst(reads)
            for name, v in row[kind].items():
                if v is not None:
                    summary.setdefault(kind, {}).setdefault(name, []).append(v)
        print(json.dumps(row), flush=True)
    out = {kind: {name: {"max": max(v), "min": min(v)}
                  for name, v in by.items()} for kind, by in summary.items()}
    print(json.dumps({"summary": out, "workload": ns.workload,
                      "plant": ns.plant,
                      "seconds": ns.seconds, "seeds": ns.seeds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
