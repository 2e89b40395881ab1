"""The four-card cell pmr446_batch.split4x16 at a tiny size on the CPU: four
gloo ranks through ``run.main``'s device hook (8 captures, 2 a rank, K = 8,
3-block pools, 2 blocks a dispatch, 1 s; 2 s traced), each in
``BatchScanner.run`` on the program's own process group.  A sound run is
correct with checks of every rank's captures taken from process 0's
gathered outputs, and a traced one reads both of the cell's readers; a
gather that swaps two ranks' rows on process 0, or a fault of
``benchlib/faults.py`` planted in process 0's sharded chain, is not
correct."""

import _paths

import json
import os
import subprocess
import sys

import pytest

from benchlib import faults, spec

CELL = "pmr446_batch.split4x16"
SEED = 2 ** 31 + 93
MIX = spec.traffic(spec.cell(spec.benchmark(), CELL)["traffic"])
#: 8 captures of 3 blocks of 8 sub-chunks (2.35 s), a quiet gap about
#: every second and a burst every third of a second, so that checks run
#: across blocks on a tuned channel; 2 blocks a dispatch, so that the CPU
#: drains groups before a traced run's stretch begins
OVERRIDES = {
    "config": {"subchunks_per_step": 8},
    "traffic": {"captures": 8, "pool_blocks": 3, "steps_per_dispatch": 2,
                "band": dict(MIX["band"], gap_every_s=1.0, gap_jitter_s=0.2,
                             gap_s=[0.25, 0.35], bursts_per_s=3.0)}}


def run_cell(trace=0, patch="", seconds=1):
    """``run.main`` on the CPU in a process of its own, after ``patch`` (code
    run in that process, rank 0's, first): (exit code, the result's line,
    the captures checked, stderr)."""
    code = "\n".join([
        f"import sys; sys.path[:0] = [{str(_paths.BENCH)!r}, "
        f"{str(_paths.ROOT)!r}]",
        "import run",
        "check = run.check",
        "def checked(cfg, window, device):",
        "    print('CAPTURES', [c.capture for c in window.checked],",
        "          file=sys.stderr)",
        "    return check(cfg, window, device)",
        "run.check = checked",
        patch,
        f"sys.exit(run.main(['--workload', {CELL!r}, '--seed', "
        f"'{SEED}', '--seconds', '{seconds}', '--trace', '{trace}'], "
        f"device='cpu', overrides={OVERRIDES!r}))"])
    out = subprocess.run([sys.executable, "-c", code], cwd=_paths.ROOT,
                         capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    caps = [json.loads(s.split(" ", 1)[1]) for s in out.stderr.splitlines()
            if s.startswith("CAPTURES ")]
    return out.returncode, line, caps[-1] if caps else None, out.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_four_cpu_ranks_correct_with_every_ranks_captures(trace):
    rc, line, caps, err = run_cell(trace, seconds=1 + trace)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True and line["failed"] == 0, line
    assert line["device"]["count"] == 1 and line["attempted"] > 0
    # 7 drawn, at least one of each rank's two captures, and the last
    assert len(caps) == MIX["check_blocks"] == 8
    assert {c // 2 for c in caps} == {0, 1, 2, 3}
    assert "ranks: 4 on cpu, cpu, cpu, cpu" in err
    limits = spec.config(spec.benchmark(), "pmr446_batch")["limits"]
    for name, c in line["checked"].items():
        assert c["limit"] == limits[name]
        assert c["value"] is None or c["value"] <= c["limit"], name
    metrics = line["metrics"]
    if trace:
        for name in ("gather_host_ms_per_block", "batch_fetch_ms_per_block"):
            assert metrics[name]["value"] > 0, name
            assert metrics[name]["unit"] == "ms"
    else:
        assert set(metrics) == {"capture_msps", "setup_s"}
        assert metrics["capture_msps"]["value"] > 0


SWAP = """
from sdr_pmr446_tpu_torch.parallel import distributed
gather = distributed.process_allgather
def swapped(tensors, mesh, time_axis=None):
    out = gather(tensors, mesh, time_axis)
    for t in out:
        t[[0, 1, 2, 3]] = t[[2, 3, 0, 1]].clone()
    return out
distributed.process_allgather = swapped
"""


def test_rows_swapped_by_the_gather_are_not_correct():
    """Process 0's gather hands rank 0's captures' rows to rank 1's and
    back: the files process 0 would write are wrong, and so is the run."""
    rc, line, caps, err = run_cell(patch=SWAP)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False and line["failed"] > 0
    assert {c // 2 for c in caps} >= {0, 1}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_in_process_0s_sharded_chain_is_not_correct(fault):
    """A fault of benchlib/faults.py planted in the step of process 0's
    sharded chain, under its megastep: its captures' outputs, and the
    run, are not correct."""
    patch = "\n".join([
        "from benchlib import faults",
        "from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (",
        "    ShardedScannerChain as S)",
        f"S.step = faults.broken_step(S.step, {fault!r})"])
    rc, line, _, err = run_cell(patch=patch)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False and line["failed"] > 0
