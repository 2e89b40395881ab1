"""The frozen work counts give PERF.md's bounds at the table's shapes."""

import _paths  # noqa: F401

import pytest

from benchlib import spec, work


def test_bounds_at_k40():
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "pmr446_scan.json")
    assert cfg["subchunks_per_step"] == 40
    # PERF.md's kernel table: K1 0.0187 ms, K2 0.0191 ms (by operations)
    assert round(work.k1_bound_ms(cfg), 4) == 0.0187
    assert round(work.k2_bound_ms(cfg), 4) == 0.0191


def test_bound_is_the_larger_of_bytes_and_operations():
    assert work.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert work.bound_ms(0, 67e9) == pytest.approx(1.0)
    assert work.bound_ms(3.35e9, 134e9) == pytest.approx(2.0)


def test_counts_follow_the_sizes():
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "pmr446_scan.json")
    half = dict(cfg, subchunks_per_step=20)
    assert work.k1_bound_ms(half) == pytest.approx(work.k1_bound_ms(cfg) / 2,
                                                   rel=1e-3)
    assert work.k2_bound_ms(half) == pytest.approx(work.k2_bound_ms(cfg) / 2,
                                                   rel=1e-3)
