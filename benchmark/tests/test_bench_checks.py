"""The check that decides ``correct``, on the CPU at a small size: the
port (its plain versions) agrees with the reference, the control (the
reference in TF32) fails a limit, and a run whose timed path is broken
underneath reports ``correct`` false, for each fault the cells can have.
The same runs on the card are ``-m cuda``."""

import _paths

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import calibrate
import run
from benchlib import faults, spec

K = 8                     # sub-chunks a block here (40 on the card)
SEED = 2 ** 31 + 77
#: the cells of BENCHMARK.json
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def small(cell):
    """The cell at a size the CPU runs in seconds: blocks of 8 sub-chunks,
    a capture of 4 blocks (3.1 s) with a quiet gap about every second and
    a burst starting every third of a second, so that checks run across
    blocks on a tuned channel."""
    mix = spec.traffic(spec.cell(spec.benchmark(), cell)["traffic"])
    band = dict(mix["band"], gap_every_s=1.0, gap_jitter_s=0.2,
                gap_s=[0.25, 0.35], bursts_per_s=3.0)
    return {"config": {"subchunks_per_step": K},
            "traffic": {"pool_blocks": 4, "check_blocks": 3,
                        "warm_groups": 1, "band": band}}


def result(capsys, cell, seconds="2"):
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   seconds], device="cpu", overrides=small(cell))
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(capsys, cell):
    line = result(capsys, cell)
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "checked"
    for name, c in line["checked"].items():
        assert c["value"] is None or c["value"] <= c["limit"], name


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(capsys, cell):
    rc = calibrate.main(["--workload", cell, "--seconds", "1", "--seeds",
                         str(SEED)], device="cpu", overrides=small(cell))
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    cfg = spec.config(spec.benchmark(), spec.cell(spec.benchmark(),
                                                  cell)["config"])
    over = [n for n, lim in cfg["limits"].items()
            if row["control"][n] is not None and row["control"][n] > lim]
    assert over, row["control"]
    assert all(row["program"][n] is None or row["program"][n] <= lim
               for n, lim in cfg["limits"].items()), row["program"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(capsys, monkeypatch, cell,
                                            fault):
    """The program's step broken underneath the whole run: the state kept,
    only the FSM's carry reset at every step (the filters handed on), one
    answer altered."""
    from sdr_pmr446_tpu_torch.scanner.chain import ScannerChain
    monkeypatch.setattr(ScannerChain, "step",
                        faults.broken_step(ScannerChain.step, fault))
    line = result(capsys, cell)
    assert line["correct"] is False and line["failed"] > 0


def test_no_card_exits_2_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure it")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                   "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_a_folder_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(_paths.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(_paths.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """A short run of each cell on the card, traced: correct, every
    per-layer metric read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark's cells)")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "5", "--trace", "1"], cwd=_paths.ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
    assert np.isfinite([m["value"] for m in line["metrics"].values()]).all()
