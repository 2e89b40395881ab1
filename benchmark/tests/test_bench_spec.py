"""Every cell, configuration, traffic mix, entry, reference and per-layer
metric of BENCHMARK.json loads by name, and a new one is new files plus new
entries, with no edit to a file that is there."""

import _paths  # noqa: F401

import json
import shutil

import pytest

import _throwaway
from benchlib import spec

BENCH = spec.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    w = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    mix = spec.traffic(w["traffic"])
    assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
    assert hasattr(spec.module("entries", cfg["entry"]),
                   "run" if w["chips"] == 1 else "run_rank")
    ref = spec.module("references", cfg["reference"])
    assert hasattr(ref, "run") and hasattr(ref, "readings")
    assert set(cfg["limits"]) == {"decisions", "rssi_gap_db", "audio_err"}
    for m in spec.metrics_of(BENCH, cell, "per_layer"):
        assert hasattr(spec.module("metrics", m["name"]), "read")
    assert {m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")} \
        == {"capture_msps", "setup_s"}


@pytest.mark.parametrize("path", sorted(
    (spec.BENCH_DIR / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_every_config_file_names_its_entry_and_reference(path):
    cfg = spec.load_json(path)
    assert cfg["name"] == path.stem
    entry = spec.module("entries", cfg["entry"])
    assert hasattr(entry, "run") or hasattr(entry, "run_rank")
    assert hasattr(spec.module("references", cfg["reference"]), "readings")


@pytest.mark.parametrize("path", sorted(
    (spec.BENCH_DIR / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_every_traffic_file_loads_by_name(path):
    mix = spec.traffic(path.stem)
    assert mix["name"] == path.stem
    assert mix["check_blocks"] >= 2
    assert set(mix["band"]) >= {"gap_every_s", "gap_jitter_s", "gap_s",
                                "bursts_per_s"}


def test_every_config_is_used_and_its_file_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A throwaway configuration, traffic mix, metric and cell, and a
    throwaway cell on four cards with its entry and reference, added to a
    copy of the benchmark: they load by name, and no file that was there
    changed."""
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    new = json.loads(json.dumps(BENCH))
    cfg = dict(spec.config(BENCH, "pmr446_scan"), name="throwaway_cfg",
               squelch_db=20.0)
    (bench / "configs" / "throwaway_cfg.json").write_text(json.dumps(cfg))
    mix = dict(spec.traffic("archive_s8"), name="throwaway_mix",
               steps_per_dispatch=2)
    (bench / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "throwaway.metric.py").write_text(
        "def read(window, cfg, mix):\n    return 42.0\n")
    new["configs"].append({"name": "throwaway_cfg", "source": "x",
                           "file": "benchmark/configs/throwaway_cfg.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "throwaway_cfg.throwaway_mix",
                             "config": "throwaway_cfg",
                             "traffic": "throwaway_mix", "chips": 1,
                             "why": "x"})
    new["per_layer"].append({"name": "throwaway.metric", "unit": "%",
                             "better": "higher", "source": "program_span",
                             "layer": "x", "moves": "capture_msps",
                             "workloads": ["throwaway_cfg.throwaway_mix"]})
    four = _throwaway.add_four_chip_cell(bench, new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    loaded = spec.benchmark(bench)
    w = spec.cell(loaded, "throwaway_cfg.throwaway_mix")
    assert spec.config(loaded, w["config"], bench)["squelch_db"] == 20.0
    assert spec.traffic(w["traffic"], bench)["steps_per_dispatch"] == 2
    names = [m["name"] for m in spec.metrics_of(
        loaded, w["name"], "per_layer")]
    assert "throwaway.metric" in names
    assert spec.module("metrics", "throwaway.metric", bench).read(
        None, None, None) == 42.0
    # the metric is only the new cell's
    assert "throwaway.metric" not in [m["name"] for m in spec.metrics_of(
        loaded, "pmr446_scan.archive_s8", "per_layer")]
    w4 = spec.cell(loaded, four)
    assert w4["chips"] == 4
    cfg4 = spec.config(loaded, w4["config"], bench)
    assert hasattr(spec.module("entries", cfg4["entry"], bench), "run_rank")
    assert hasattr(spec.module("references", cfg4["reference"], bench),
                   "readings")
    assert spec.traffic(w4["traffic"], bench)["name"] == w4["traffic"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_names_and_units_use_the_allowed_characters():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in BENCH[group]:
            assert name.match(item["name"]), item["name"]
            if "unit" in item:
                assert unit.match(item["unit"]), item["unit"]
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert name.match(w["traffic"]) and len(w["why"]) <= 200
    # at most a quarter of the cells, rounded down, on four cards; one may
    fours = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(BENCH["workloads"]) // 4), fours
