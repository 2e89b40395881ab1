"""Sets of runs of one cell, and each end-to-end metric's spread (not part
of a run).

    python3 benchmark/spread.py --workload pmr446_scan.archive_s8 \\
        --seconds 30 --sets 2 --seeds 101 102 103 104 105 106 [--out DIR]

Runs ``benchmark/run.py`` once a seed, one process at a time, the seeds in
the same order in every set, and prints each run's result line and then,
for each metric, each set's median and spread: the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) over the
median, and the widest spread over the sets.  A run that is not correct,
or exits with another code than 0, is printed and counted.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", help="folder for each run's standard error")
    ns = p.parse_args(argv)
    runs: list = []
    bad = 0
    for s in range(ns.sets):
        for seed in ns.seeds:
            cmd = [sys.executable, os.path.join(HERE, "run.py"),
                   "--workload", ns.workload, "--seed", str(seed),
                   "--seconds", str(ns.seconds), "--trace", str(ns.trace)]
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 cwd=os.path.dirname(HERE))
            if ns.out:
                os.makedirs(ns.out, exist_ok=True)
                with open(os.path.join(ns.out, f"set{s}_{seed}.err"),
                          "w") as f:
                    f.write(out.stderr)
            lines = out.stdout.strip().splitlines()
            line = None
            if out.returncode == 0 and lines:
                line = json.loads(lines[-1])
            ok = line is not None and line["correct"]
            bad += not ok
            print(json.dumps({"set": s, "seed": seed, "rc": out.returncode,
                              "line": line,
                              "stderr_tail": None if ok
                              else out.stderr[-2000:]}), flush=True)
            runs.append((s, line))
    summary: dict = {}
    names = sorted({m for _, line in runs if line for m in line["metrics"]})
    for name in names:
        per_set = []
        for s in range(ns.sets):
            vals = [line["metrics"][name]["value"] for t, line in runs
                    if t == s and line and name in line["metrics"]]
            if len(vals) >= 2:
                per_set.append({"median": statistics.median(vals),
                                "spread": spread(vals), "n": len(vals),
                                "values": vals})
        summary[name] = {"sets": per_set,
                         "widest": max((x["spread"] for x in per_set),
                                       default=None)}
    print(json.dumps({"workload": ns.workload, "seconds": ns.seconds,
                      "not_correct": bad, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
